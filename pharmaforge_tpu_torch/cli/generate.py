"""Arbitrary-receptor generation CLI of the port.

    python -m pharmaforge_tpu_torch.cli.generate receptor.pdb \
        --ref_ligand_file ligand.sdf --model_dir <run_dir> \
        --samples_per_pocket 30

Port of the JAX package's `generate_pharmacophores.py`, flag for flag
(reference generate_pharmacophores.py): the pocket is the standard amino
acids within `pocket_cutoff` of a reference ligand (SDF), or an explicit
`chain:resid` list; its dense arrays go through the reverse chain, and
`<output_dir>/<receptor>/` gets `pocket.pdb`, `pharms.xyz` (or one
trajectory file per sample), `sample_time.txt`, `sample_time.pkl` and
`reference_files/`. Receptors and ligands are read with the builtin
parsers of `preprocessing/structure.py` (PDB, mmCIF, SDF V2000): the path
the JAX CLI takes without biopython and rdkit. Random draws come from one
`torch.Generator` on `--device` (CUDA by default; without CUDA it raises
unless given `--device cpu`), seeded with `--seed`. `--latency_mode on`
builds the chain's step tables (`DiffusionConfig.precompute_step_tables`,
JAX generate_pharmacophores.py:312-324); `auto` and `off` run the
per-step chain, as the JAX CLI's `auto` does.
"""

from __future__ import annotations

import dataclasses
import pickle
import shutil
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.analysis.pharm_builder import SampledPharmacophore
from pharmaforge_tpu_torch.config.cmdline import ArgumentParser
from pharmaforge_tpu_torch.models.size_dist import PharmSizeDistribution
from pharmaforge_tpu_torch.preprocessing.structure import (
    STANDARD_AA,
    group_residues,
    parse_sdf_coords,
    parse_structure_atoms,
    write_pdb_lines,
)
from pharmaforge_tpu_torch.training.restore import load_model, resolve_run_dir
from pharmaforge_tpu_torch.training.sampling import PocketSampler
from pharmaforge_tpu_torch.utils.misc import (
    MATMUL_PRECISIONS,
    get_prot_atom_ph_type_maps,
    matmul_precision,
)


def parse_arguments(argv: Optional[Sequence[str]] = None):
    p = ArgumentParser(prog="pharmaforge_tpu_torch.cli.generate")
    p.add_argument('receptor_file', type=Path, help='PDB file of the receptor')
    p.add_argument('--ref_ligand_file', type=Path,
                   help='sdf file of ligand used to define the pocket')
    p.add_argument('--residue_list', nargs='+', type=str, default=[],
                   help='Residues that define the pocket in the form '
                        'chain ID:residue idx')
    p.add_argument('--ckpt', type=Path, default=None,
                   help='Path to checkpoint file. Must be inside model dir.')
    p.add_argument('--model_dir', type=Path, default=None,
                   help='Directory of output from a training run. Will use '
                        'the last checkpoint in this directory.')
    p.add_argument('--samples_per_pocket', type=int, default=1,
                   help='number of samples generated per pocket')
    p.add_argument('--pharm_sizes', nargs='+', type=int, default=[],
                   help='number of pharmacophore centers in each sample, '
                        'must be of length samples per pocket')
    p.add_argument('--output_dir', type=str, default='generated_pharms/')
    p.add_argument('--receptor_name', type=str, default=None)
    p.add_argument('--max_batch_size', type=int, default=128,
                   help='maximum feasible batch size due to memory constraints')
    p.add_argument('--seed', type=int, default=42,
                   help='random seed as an integer.')
    p.add_argument('--use_ref_lig_com', action='store_true',
                   help="Initialize each pharmacophore's position at the "
                        "reference ligand's center of mass")
    p.add_argument('--visualize_trajectory', action='store_true',
                   help='Visualize trajectories of generated pharmacophores')
    p.add_argument('--metrics', action='store_true',
                   help='compute metrics on generated pharmacophores '
                        '(requires receptor pharmacophore sites; like the '
                        'reference, the arbitrary-receptor path has none)')
    p.add_argument('--matmul_precision', type=str, default='float32',
                   choices=sorted(MATMUL_PRECISIONS),
                   help='float32 matmul policy of the sampling chain '
                        '(utils/misc.py)')
    p.add_argument('--latency_mode', type=str, default='auto',
                   choices=['auto', 'on', 'off'],
                   help='precomputed per-step tables '
                        '(DiffusionConfig.precompute_step_tables) for the '
                        'sampling chain: "on" builds them before the chain; '
                        '"auto" and "off" run the per-step chain')
    p.add_argument('--device', type=str, default='cuda',
                   help="device to sample on; without CUDA, 'cpu' must be "
                        "given")
    args = p.parse_args(argv)

    if args.ckpt is not None and args.model_dir is not None:
        raise ValueError('only model_file or model_dir can be specified but not both')
    if args.ckpt is None and args.model_dir is None:
        raise ValueError('one of model_file or model_dir must be specified')
    if args.pharm_sizes and len(args.pharm_sizes) != args.samples_per_pocket:
        raise ValueError('If pharm_sizes list is provided, must be of length '
                         'sample per pocket')
    if args.ref_ligand_file is None and len(args.residue_list) == 0:
        raise ValueError('Either ref_ligand or residue_list must be specified')
    if args.ref_ligand_file is not None and len(args.residue_list) != 0:
        print('WARNING: Both reference ligand file and residue list specified. '
              'Reference ligand will be used to define pocket in this case.')
    return args


def element_fixer(element: str) -> str:
    if len(element) > 1:
        element = element[0] + element[1:].lower()
    return element


def onehot_encode_elements(atom_elements: Iterable,
                           element_map: Dict[str, int]) -> np.ndarray:
    """One-hot with an 'other' bucket in the final column
    (reference generate_pharmacophores.py:104-117)."""
    element_idxs = np.fromiter(
        (element_map.get(e, element_map['other']) for e in atom_elements),
        int)
    onehot = np.zeros((element_idxs.size, len(element_map)))
    onehot[np.arange(element_idxs.size), element_idxs] = 1
    return onehot


def process_ligand_and_pocket(rec_file: Path, output_dir: Path,
                              prot_element_map: Dict[str, int],
                              pocket_cutoff: float,
                              lig_file: Optional[Path] = None,
                              residue_list: Sequence[str] = (),
                              remove_hydrogen: bool = True) -> dict:
    """The dense pocket arrays of an arbitrary receptor (reference
    generate_pharmacophores.py:120-220), as the JAX CLI builds them
    without biopython: standard-AA residues of the receptor's polymer
    atoms within `pocket_cutoff` of the ligand, or an explicit
    `chain:resid` list. Writes `output_dir/pocket.pdb` (every atom of the
    chosen residues) and returns {'prot_x', 'prot_h', 'init_com'} with
    hydrogens and 'other' elements dropped from the arrays."""
    if lig_file is None and len(residue_list) == 0:
        raise ValueError('Either reference ligand or pocket residue list '
                         'must be provided.')
    if rec_file.suffix not in ('.pdb', '.mmcif', '.cif'):
        raise ValueError(f'unsupported receptor file type: '
                         f'{rec_file.suffix}, must be .pdb or .mmcif')
    atoms = parse_structure_atoms(rec_file)
    # polymer residues only: ATOM records with a blank insertion code
    residues = group_residues(a for a in atoms
                              if a.record == 'ATOM' and a.icode == ' ')

    if lig_file is not None:
        lig_coords = parse_sdf_coords(lig_file,
                                      remove_hydrogen=remove_hydrogen)
        init_com = lig_coords.mean(axis=0).reshape(1, 3)
        pocket_residues = []
        for key, res_atoms in residues:
            if key[3] not in STANDARD_AA:
                continue
            res_coords = np.stack([a.coord for a in res_atoms])
            d2 = np.sum((lig_coords[:, None] - res_coords[None]) ** 2, -1)
            if float(d2.min()) < pocket_cutoff ** 2:
                pocket_residues.append((key, res_atoms))
        if len(pocket_residues) == 0:
            raise ValueError('no valid pocket residues found.')
    else:
        wanted = [(r.split(':')[0], int(r.split(':')[1]))
                  for r in residue_list]
        by_id = {(k[0], k[1]): (k, v) for k, v in residues}
        missing = [w for w in wanted if w not in by_id]
        if missing:
            raise ValueError(f'pocket residues not found in receptor: '
                             f'{missing}')
        pocket_residues = [by_id[w] for w in wanted]
        pocket_coords = np.stack([a.coord for _, res in pocket_residues
                                  for a in res])
        init_com = pocket_coords.mean(axis=0).reshape(1, 3)

    pocket_atoms = [a for _, res in pocket_residues for a in res
                    if not (remove_hydrogen and a.element == 'H')]
    pocket_coords = np.stack([a.coord for a in pocket_atoms])
    pocket_elements = np.array([element_fixer(a.element)
                                for a in pocket_atoms])
    write_pdb_lines([a for _, res in pocket_residues for a in res],
                    output_dir / 'pocket.pdb')

    onehot_elements = onehot_encode_elements(pocket_elements,
                                             prot_element_map)
    other_mask = onehot_elements[:, -1] == 1
    return {
        'prot_x': np.asarray(pocket_coords, np.float32)[~other_mask],
        'prot_h': onehot_elements[:, :-1].astype(np.float32)[~other_mask],
        'init_com': init_com.astype(np.float32),
    }


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Generate as the command line `argv` says; returns the receptor's
    output directory."""
    args = parse_arguments(argv)
    device = resolve_device(args.device)
    with matmul_precision(args.matmul_precision):
        return _run(args, device)


def _run(args, device: torch.device) -> Path:
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    run_dir, which = resolve_run_dir(args.ckpt, args.model_dir)
    model, config = load_model(run_dir, which, device=device)
    if args.latency_mode == 'on':
        # the weights do not depend on the config: the same model, with
        # the tables on
        model.config = dataclasses.replace(model.config,
                                           precompute_step_tables=True)

    dataset_config = config['dataset']
    prot_element_map, _ = get_prot_atom_ph_type_maps(dataset_config)

    rec_file = args.receptor_file
    if not rec_file.exists():
        raise ValueError('receptor file does not exist')
    if args.ref_ligand_file and not args.ref_ligand_file.exists():
        raise ValueError('ligand file does not exist')

    rec_name = args.receptor_name or rec_file.name.split('.')[0]
    pocket_dir = output_dir / rec_name
    pocket_dir.mkdir(exist_ok=True)

    pocket = process_ligand_and_pocket(
        rec_file, pocket_dir,
        prot_element_map=prot_element_map,
        pocket_cutoff=dataset_config['pocket_cutoff'],
        lig_file=args.ref_ligand_file,
        residue_list=args.residue_list,
        remove_hydrogen=True)

    size_dist = PharmSizeDistribution(
        dataset_config.get('processed_data_dir'), seed=args.seed)
    if args.pharm_sizes:
        pharm_sizes = list(args.pharm_sizes)
    else:
        pharm_sizes = list(size_dist.sample_uniformly(args.samples_per_pocket))

    init_com = pocket['init_com'][0] if args.use_ref_lig_com else None

    sampler = PocketSampler(model,
                            pharm_type_map=dataset_config['ph_type_map'],
                            device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    pocket_sample_start = time.time()
    sampled_pharms: List[SampledPharmacophore] = sampler.sample_pocket(
        pocket, pharm_sizes, generator,
        max_batch_size=args.max_batch_size, init_pharm_com=init_com,
        visualize_trajectory=args.visualize_trajectory)
    pocket_sample_time = time.time() - pocket_sample_start

    with open(pocket_dir / 'sample_time.txt', 'w') as f:
        f.write(f'{pocket_sample_time:.2f}')
    with open(pocket_dir / 'sample_time.pkl', 'wb') as f:
        pickle.dump([pocket_sample_time], f)

    print(f'Pocket {rec_name} sampling time: {pocket_sample_time:.2f} seconds')
    print(f'Pocket {rec_name} sampling time per pharmacophore: '
          f'{pocket_sample_time / len(sampled_pharms):.2f} seconds')

    ref_files_dir = pocket_dir / 'reference_files'
    ref_files_dir.mkdir(exist_ok=True)
    shutil.copy(rec_file, ref_files_dir / rec_file.name)
    if args.ref_ligand_file is not None:
        shutil.copy(args.ref_ligand_file,
                    ref_files_dir / args.ref_ligand_file.name)

    if args.visualize_trajectory:
        for pharm_idx, sampled_pharm in enumerate(sampled_pharms):
            sampled_pharm.traj_to_xyz(pocket_dir / f'pharm_{pharm_idx}_traj.xyz')
    else:
        pharm_file_content = ''.join(ph.to_xyz_file() for ph in sampled_pharms)
        with open(pocket_dir / 'pharms.xyz', 'w') as f:
            f.write(pharm_file_content)
    return pocket_dir


if __name__ == '__main__':
    main()
