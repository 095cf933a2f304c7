"""Dataset-driven sampling and evaluation CLI of the port.

    python -m pharmaforge_tpu_torch.cli.test --model_dir <run_dir> \
        --samples_per_pocket 8 --metrics

Port of the JAX package's `test.py`, flag for flag (reference test.py):
samples N pharmacophores for each pocket of the val (or train) split of
the run's processed dataset and writes, per pocket, `pharms.xyz` (or one
trajectory file per sample), `sample_time.txt` and `sample_time.pkl`;
with `--metrics`, validity and its per-type breakdown (`metrics.txt`,
`metrics.pkl`) and the type histogram (`pharm_counts_*`). Where a
pocket's raw receptor file exists, `pocket.pdb` and `reference_files/`
(the receptor and the ligand) are written too; without Biopython or
RDKit a `skipping pocket.pdb/reference files (...)` line says why.
Multi-pocket sweeps run stacked, several pockets per device batch, the
last chunk padded with its final pocket; `--pockets_per_call 1` runs
pocket by pocket. Random draws come from one `torch.Generator` on `--device` (CUDA
by default; without CUDA it raises unless given `--device cpu`), seeded
with `--seed`; pharmacophore sizes from the numpy-seeded size
distribution, as in the JAX CLI. `--n_devices N` (above 1) starts N
local ranks (`parallel/mesh.py`), rank r on cuda:r or all on the CPU with
`--device cpu`: each device batch is split over the ranks as
`PocketSampler` documents, and rank 0 alone writes the outputs.
"""

from __future__ import annotations

import pickle
import shutil
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.analysis.metrics import SampleAnalyzer
from pharmaforge_tpu_torch.analysis.pharm_builder import SampledPharmacophore
from pharmaforge_tpu_torch.config.cmdline import ArgumentParser
from pharmaforge_tpu_torch.config.load_from_config import (
    data_module_from_config,
)
from pharmaforge_tpu_torch.constants import PH_IDX_TO_TYPE
from pharmaforge_tpu_torch.data.batch import bucket_size
from pharmaforge_tpu_torch.models.size_dist import PharmSizeDistribution
from pharmaforge_tpu_torch.parallel.mesh import (
    init_distributed,
    is_main,
    spawn_local,
)
from pharmaforge_tpu_torch.preprocessing.receptor_utils import (
    write_pocket_file,
)
from pharmaforge_tpu_torch.training.restore import load_model, resolve_run_dir
from pharmaforge_tpu_torch.training.sampling import PocketSampler
from pharmaforge_tpu_torch.utils.misc import (
    MATMUL_PRECISIONS,
    matmul_precision,
)

def parse_arguments(argv: Optional[Sequence[str]] = None):
    p = ArgumentParser(prog="pharmaforge_tpu_torch.cli.test")
    p.add_argument('--ckpt', type=Path, default=None,
                   help='Path to checkpoint file. Must be inside model dir.')
    p.add_argument('--model_dir', type=Path, default=None,
                   help='Directory of output from a training run. Will use the '
                        'last checkpoint in this directory.')
    p.add_argument('--samples_per_pocket', type=int, default=1,
                   help='number of samples generated per pocket')
    p.add_argument('--pharm_sizes', nargs='*', type=int, default=[],
                   help='number of pharmacophore centers in each sample, must '
                        'be of length samples per pocket')
    p.add_argument('--max_batch_size', type=int, default=128,
                   help='maximum feasible batch size due to memory constraints')
    p.add_argument('--seed', type=int, default=42)
    p.add_argument('--output_dir', type=Path, default=None)
    p.add_argument('--max_tries', type=int, default=1,
                   help='maximum number of batches to sample per pocket')
    p.add_argument('--dataset_size', type=int, default=None,
                   help='truncate test dataset')
    p.add_argument('--dataset_idx', type=int, default=None)
    p.add_argument('--dataset_idx_as_start', action='store_true',
                   help='Use dataset idx as starting index and sample dataset size')
    p.add_argument('--split', type=str, default='val',
                   help='which data split to use; val or train')
    p.add_argument('--use_ref_pharm_com', action='store_true',
                   help="Initialize each pharmacophore's position at the "
                        "reference pharmacophore's center of mass")
    p.add_argument('--visualize_trajectory', action='store_true',
                   help='Visualize trajectories of generated pharmacophores')
    p.add_argument('--metrics', action='store_true',
                   help='compute metrics on generated pharmacophores')
    p.add_argument('--matmul_precision', type=str, default='float32',
                   choices=sorted(MATMUL_PRECISIONS),
                   help='float32 matmul policy of the sampling chain '
                        '(utils/misc.py)')
    p.add_argument('--n_devices', type=int, default=None,
                   help='data-parallel ranks (one per device) to split '
                        'the sampling batches over (default: 1)')
    p.add_argument('--pockets_per_call', type=int, default=None,
                   help='pockets stacked into one device batch during '
                        'multi-pocket sweeps (default: max_batch_size // '
                        'samples_per_pocket). 1 runs pocket by pocket')
    p.add_argument('--device', type=str, default='cuda',
                   help="device to sample on; without CUDA, 'cpu' must be "
                        "given")
    args = p.parse_args(argv)

    if args.ckpt is None and args.model_dir is None:
        raise ValueError('Must provide either --ckpt or --model_dir')
    if args.pharm_sizes and len(args.pharm_sizes) != args.samples_per_pocket:
        raise ValueError('If pharm_sizes list is provided, must be of length '
                         'samples per pocket')
    return args


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Sample and evaluate as the command line `argv` says; returns the
    output directory."""
    args = parse_arguments(argv)
    device = resolve_device(args.device)
    if args.n_devices is not None and args.n_devices > 1:
        return spawn_local(args.n_devices, _rank_main, args)[0]
    with matmul_precision(args.matmul_precision):
        return _run(args, device)


def _rank_main(args) -> Path:
    """One rank of a data-parallel run: join the group, sample, leave."""
    import torch.distributed as dist
    device = init_distributed(device=args.device)
    try:
        with matmul_precision(args.matmul_precision):
            return _run(args, device)
    finally:
        dist.destroy_process_group()


def _run(args, device: torch.device) -> Path:
    main_rank = is_main()
    run_dir, which = resolve_run_dir(args.ckpt, args.model_dir)
    output_dir = args.output_dir or (run_dir / 'samples')
    if main_rank:
        output_dir.mkdir(parents=True, exist_ok=True)
    pharm_dir = output_dir

    model, config = load_model(run_dir, which, device=device)

    test_data_module = data_module_from_config(config)
    if args.split == 'train':
        test_data_module.setup('fit')
        test_dataset = test_data_module.train_dataset
    else:
        test_data_module.setup('test')
        test_dataset = test_data_module.val_dataset

    # every pocket padded to the dataset-wide slot count, so a sweep's
    # batches share one shape
    sizes = test_dataset.prot_idx[:, 1] - test_dataset.prot_idx[:, 0]
    sampler = PocketSampler(model,
                            pharm_type_map=config['dataset']['ph_type_map'],
                            fixed_prot_slots=bucket_size(int(sizes.max())),
                            device=device)
    size_dist = PharmSizeDistribution(
        config['dataset'].get('processed_data_dir'), seed=args.seed)

    if args.dataset_idx is None:
        dataset_size = args.dataset_size or len(test_dataset)
        dataset_iterator = range(dataset_size)
    elif args.dataset_idx_as_start:
        if args.dataset_size is None:
            raise ValueError('Must provide dataset size if '
                             'dataset_idx_as_start is used')
        dataset_size = args.dataset_size
        dataset_iterator = range(args.dataset_idx,
                                 args.dataset_idx + dataset_size)
    else:
        dataset_size = 1
        dataset_iterator = range(args.dataset_idx, args.dataset_idx + 1)

    generator = torch.Generator(device=device).manual_seed(args.seed)

    pocket_sampling_times = []
    all_pharms: List[SampledPharmacophore] = []

    def write_pocket_outputs(dataset_idx, sampled_pharms,
                             pocket_sample_time):
        """Per-pocket artifact layout (reference test.py:185-235), written
        by rank 0."""
        if not main_rank:
            return
        pocket_sampling_times.append(pocket_sample_time)
        pocket_dir = pharm_dir / f'pocket_{dataset_idx}'
        pocket_dir.mkdir(exist_ok=True)
        all_pharms.extend(sampled_pharms)

        with open(pocket_dir / 'sample_time.txt', 'w') as f:
            f.write(f'{pocket_sample_time:.2f}')
        with open(pocket_dir / 'sample_time.pkl', 'wb') as f:
            pickle.dump(pocket_sampling_times, f)

        print(f'Pocket {dataset_idx} sampling time: '
              f'{pocket_sample_time:.2f} seconds')
        print(f'Pocket {dataset_idx} sampling time per pharmacophore: '
              f'{pocket_sample_time / len(sampled_pharms):.2f} seconds')

        raw_data_dir, ref_prot_file, ref_lig_rdmol = \
            test_dataset.get_files(dataset_idx)
        # pocket.pdb and the reference files need the raw CrossDocked
        # files, RDKit and Biopython; without the toolkits a line says so
        if ref_prot_file is not None and raw_data_dir:
            ref_path = Path(raw_data_dir) / ref_prot_file
            if ref_path.exists():
                try:
                    write_pocket_file(ref_path, ref_lig_rdmol,
                                      pocket_dir / 'pocket.pdb',
                                      cutoff=config['dataset']['pocket_cutoff'])
                    ref_files_dir = pocket_dir / 'reference_files'
                    ref_files_dir.mkdir(exist_ok=True)
                    shutil.copy(ref_path, ref_files_dir / ref_path.name)
                    if ref_lig_rdmol is not None:
                        from rdkit import Chem
                        w = Chem.SDWriter(str(ref_files_dir / 'ligand.sdf'))
                        w.write(ref_lig_rdmol, confId=0)
                        w.close()
                except ImportError as e:
                    print(f'skipping pocket.pdb/reference files ({e})')

        if args.visualize_trajectory:
            for pharm_idx, sampled_pharm in enumerate(sampled_pharms):
                sampled_pharm.traj_to_xyz(
                    pocket_dir / f'pharm_{pharm_idx}_traj.xyz')
        else:
            pharm_file_content = ''.join(
                ph.to_xyz_file() for ph in sampled_pharms)
            with open(pocket_dir / 'pharms.xyz', 'w') as f:
                f.write(pharm_file_content)

    # the sweep is gathered up front so that several pockets can share a
    # device batch
    sweep = []
    for dataset_idx in dataset_iterator:
        pocket = test_dataset[dataset_idx]
        if args.pharm_sizes:
            pharm_sizes = list(args.pharm_sizes)
        else:
            pharm_sizes = list(size_dist.sample_uniformly(
                args.samples_per_pocket))
        init_com = pocket['pharm_x'].mean(axis=0) if args.use_ref_pharm_com \
            else None
        sweep.append((dataset_idx, pocket, pharm_sizes, init_com))

    samples_each = len(sweep[0][2])
    stacked = (len(sweep) > 1 and not args.visualize_trajectory
               and args.pockets_per_call != 1
               and samples_each <= args.max_batch_size
               and all(len(s[2]) == samples_each for s in sweep))
    if stacked:
        ppc = args.pockets_per_call or max(
            1, args.max_batch_size // samples_each)
        ppc = min(ppc, len(sweep))
        sweep_start = time.time()
        for start in range(0, len(sweep), ppc):
            group = sweep[start:start + ppc]
            n_real = len(group)
            # the last chunk is padded with its final pocket, so every
            # chunk has one shape; the padded outputs are dropped
            group = group + [group[-1]] * (ppc - n_real)
            coms = None
            if args.use_ref_pharm_com:
                coms = np.stack([g[3] for g in group]).astype(np.float32)
            t0 = time.time()
            per_pocket = sampler.sample_stacked(
                [g[1] for g in group], [g[2] for g in group], generator,
                init_pharm_com=coms)
            chunk_time = time.time() - t0
            # a pocket's wall time is its share of the stacked call
            for (dataset_idx, _, _, _), pharms in list(
                    zip(group, per_pocket))[:n_real]:
                write_pocket_outputs(dataset_idx, pharms,
                                     chunk_time / n_real)
        total = time.time() - sweep_start
        n_samples = sum(len(s[2]) for s in sweep)
        if main_rank:
            print(f'Sweep: {len(sweep)} pockets x {samples_each} samples in '
                  f'{total:.2f}s stacked {ppc}/call '
                  f'({n_samples / total:.2f} samples/s)')
    else:
        for dataset_idx, pocket, pharm_sizes, init_com in sweep:
            pocket_sample_start = time.time()
            sampled_pharms = sampler.sample_pocket(
                pocket, pharm_sizes, generator,
                max_batch_size=args.max_batch_size,
                init_pharm_com=init_com,
                visualize_trajectory=args.visualize_trajectory)
            write_pocket_outputs(dataset_idx, sampled_pharms,
                                 time.time() - pocket_sample_start)

    if args.metrics and main_rank:
        analyzer = SampleAnalyzer()
        metrics = analyzer.analyze(all_pharms)
        print(metrics)
        # the per-type breakdown follows the reference's single number
        metrics.update(analyzer.analyze_per_type(all_pharms))
        with open(output_dir / 'metrics.txt', 'w') as f:
            f.write('\n'.join(f'{k}: {v:.3f}' for k, v in metrics.items()))
        with open(output_dir / 'metrics.pkl', 'wb') as f:
            pickle.dump(metrics, f)

        freqs = analyzer.pharm_feat_freq(all_pharms)
        with open(output_dir / f'pharm_counts_{args.dataset_idx}.txt',
                  'w') as f:
            f.write(str(freqs))
        with open(output_dir / f'pharm_counts_{args.dataset_idx}.pkl',
                  'wb') as f:
            pickle.dump(freqs, f)
        _plot_freqs(freqs, dataset_size,
                    output_dir / f'pharm_freq_plot_{args.dataset_idx}.png')
    return output_dir


def _plot_freqs(freqs: np.ndarray, dataset_size: int, path: Path) -> None:
    """The type histogram as a bar plot, where matplotlib is installed."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    plt.bar(PH_IDX_TO_TYPE, freqs)
    plt.xticks(rotation=90)
    plt.xlabel('Pharmacophore Feature')
    plt.ylabel('Feature Count')
    plt.title(f'Pharmacophore Type Counts for {dataset_size} Pockets')
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


if __name__ == '__main__':
    main()
