"""Training CLI of the port.

    python -m pharmaforge_tpu_torch.cli.train --config configs/dev.yml
    python -m pharmaforge_tpu_torch.cli.train --resume <run_dir>

Port of the JAX package's `train.py`, flag for flag (reference train.py):
the YAML config is the source of truth, the hyperparameter flags of
`config/cmdline.py` override it, `--resume` takes a run dir or one of its
checkpoint directories, and `--debug` caps an epoch at 100 batches with
wandb off. A new run writes `<output_dir>/<name>_<run_id>/` with
`config.yaml` (holding `resume.run_id`), `metrics.jsonl` and
`checkpoints/`. It runs on `--device` (CUDA by default; without CUDA it
raises unless given `--device cpu`).

Data parallelism (`parallel/mesh.py`, one process per device): `--n_devices
N` starts N local ranks, rank r on cuda:r (or all on the CPU with
`--device cpu`); `--distributed` joins a group started elsewhere, with
`--coordinator host:port`, `--num_processes` and `--process_id`, each
taken from `torchrun`'s environment where not given. Rank 0 alone makes
the synthetic dataset, the run dir, config.yaml, metrics and checkpoints.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Sequence

from pharmaforge_tpu_torch import resolve_device
from pharmaforge_tpu_torch.config.cmdline import (
    ArgumentParser,
    merge_config_and_args,
    register_hyperparameter_args,
)
from pharmaforge_tpu_torch.config.load_from_config import (
    data_module_from_config,
    model_from_config,
)
from pharmaforge_tpu_torch.config.yaml_io import dump_file, load_file
from pharmaforge_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_object,
    init_distributed,
    is_main,
    spawn_local,
)
from pharmaforge_tpu_torch.training.logging import (
    MetricsLogger,
    NullLogger,
    generate_run_id,
)
from pharmaforge_tpu_torch.training.trainer import Trainer


def parse_arguments(argv: Optional[Sequence[str]] = None):
    p = ArgumentParser(prog="pharmaforge_tpu_torch.cli.train")
    p.add_argument('--config', type=str, default=None)
    p.add_argument('--resume', type=Path, default=None)
    p.add_argument('--debug', action='store_true')
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--device', type=str, default='cuda',
                   help="device to train on; without CUDA, 'cpu' must be "
                        "given")
    p.add_argument('--n_devices', type=int, default=None,
                   help='data-parallel ranks started on this host, one per '
                        'device (cuda:0.., or the CPU with --device cpu)')
    p.add_argument('--distributed', action='store_true',
                   help='join a data-parallel process group started '
                        'elsewhere; rank 0 owns the run dir, logs and '
                        'checkpoints')
    p.add_argument('--coordinator', type=str, default=None,
                   help='host:port of rank 0 for --distributed (default: '
                        'MASTER_ADDR:MASTER_PORT)')
    p.add_argument('--num_processes', type=int, default=None,
                   help='ranks of the group for --distributed (default: '
                        'WORLD_SIZE)')
    p.add_argument('--process_id', type=int, default=None,
                   help='this process rank for --distributed (default: '
                        'RANK)')
    p = register_hyperparameter_args(p)
    args = p.parse_args(argv)
    if args.config is not None and args.resume is not None:
        raise ValueError('only specify a config file or a resume file but '
                         'not both')
    if args.distributed and args.n_devices is not None \
            and args.n_devices > 1:
        raise ValueError('--n_devices starts its own ranks; it does not '
                         'join --distributed')
    return args


def maybe_make_synthetic(config: dict) -> None:
    """Write a synthetic processed dataset where the config asks for one
    and its directory is absent: three splits of a third of
    `dataset_size` (96 by default) each, at least 8."""
    ds = config['dataset']
    if not ds.get('synthetic'):
        return
    processed = Path(ds['processed_data_dir'])
    if processed.exists():
        return
    from pharmaforge_tpu_torch.data.synthetic import (
        make_synthetic_processed_dataset)
    print(f'generating synthetic processed dataset at {processed}')
    n_splits = 3
    per_split = max(math.ceil((ds.get('dataset_size') or 96) / n_splits), 8)
    make_synthetic_processed_dataset(
        processed, n_splits=n_splits, samples_per_split=per_split,
        site_rule=ds.get('synthetic_site_rule', 'random'))


def resume_target(path: Path):
    """(run dir, checkpoint to resume from) of --resume: a run dir resumes
    from 'last'; a checkpoint directory of a run (it holds `meta.json`)
    from itself."""
    if path.is_dir() and (path / 'meta.json').exists():
        for parent in path.parents:
            if parent.name == 'checkpoints':
                return parent.parent, str(path)
    if path.is_dir():
        return path, 'last'
    raise ValueError('resume argument must be a run directory or a '
                     'checkpoint that must already exist')


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Train as the command line `argv` says; returns the run dir."""
    args = parse_arguments(argv)
    device = resolve_device(args.device)
    if args.n_devices is not None and args.n_devices > 1:
        return spawn_local(args.n_devices, _rank_main, args)[0]
    if args.distributed:
        return _rank_main(args, args.coordinator, args.num_processes,
                          args.process_id)
    return _train(args, device)


def _rank_main(args, coordinator=None, num_processes=None,
               process_id=None) -> Path:
    """One rank of a data-parallel run: join the group, train, leave."""
    import torch.distributed as dist
    device = init_distributed(coordinator, num_processes, process_id,
                              args.device)
    try:
        return _train(args, device)
    finally:
        dist.destroy_process_group()


def _train(args, device) -> Path:
    ckpt_resume = None
    if args.resume is not None:
        run_dir, ckpt_resume = resume_target(args.resume)
        config_file = run_dir / 'config.yaml'
    else:
        config_file = args.config
        run_dir = None

    seed = args.seed if args.seed is not None else 0
    config = merge_config_and_args(load_file(config_file), args)
    if is_main():
        maybe_make_synthetic(config)
    # the other ranks read the dataset rank 0 may have just written
    barrier()

    data_module = data_module_from_config(config)
    model = model_from_config(config, device=device, seed=seed)

    wandb_config = dict(config.get('wandb', {}))
    if args.debug:
        wandb_config['mode'] = 'disabled'
        wandb_config['name'] = 'debug_run'

    output_dir = Path(config['training']['output_dir'])
    if is_main():
        output_dir.mkdir(parents=True, exist_ok=True)

    if args.resume is None:
        # every rank takes rank 0's run id
        run_id = broadcast_object(generate_run_id())
        wandb_config['id'] = run_id
        name = wandb_config.get('name', 'run').replace(' ', '-')
        run_dir = output_dir / f'{name}_{run_id}'
        config.setdefault('resume', {})['run_id'] = run_id
        if is_main():
            run_dir.mkdir(parents=True, exist_ok=True)
            print('Results are being written to:', run_dir)
            dump_file(config, run_dir / 'config.yaml')
    else:
        wandb_config['id'] = config.get('resume', {}).get('run_id',
                                                          'resumed')
        wandb_config['resume'] = 'must'

    wandb_config['save_dir'] = str(output_dir)
    logger = (MetricsLogger(run_dir, wandb_config, full_config=config)
              if is_main() else NullLogger())
    trainer = Trainer(config, run_dir, logger=logger, debug=args.debug,
                      seed=seed, device=device)
    try:
        trainer.fit(model, data_module, resume_from=ckpt_resume)
    finally:
        logger.finish()
    return run_dir


if __name__ == '__main__':
    main()
