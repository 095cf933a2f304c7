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
raises unless given `--device cpu`). The JAX CLI's multi-device flags
parse and raise: they wait for ROADMAP A.7.
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
from pharmaforge_tpu_torch.training.logging import (
    MetricsLogger,
    generate_run_id,
)
from pharmaforge_tpu_torch.training.trainer import Trainer

MULTI_GPU = "ROADMAP A.7 (multi-GPU)"


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
                   help=f'data-parallel devices; above 1 waits for '
                        f'{MULTI_GPU}')
    p.add_argument('--distributed', action='store_true',
                   help=f'multi-host data parallelism; waits for '
                        f'{MULTI_GPU}')
    p.add_argument('--coordinator', type=str, default=None,
                   help=f'coordinator address for --distributed; waits for '
                        f'{MULTI_GPU}')
    p.add_argument('--num_processes', type=int, default=None,
                   help=f'process count for --distributed; waits for '
                        f'{MULTI_GPU}')
    p.add_argument('--process_id', type=int, default=None,
                   help=f'this process rank for --distributed; waits for '
                        f'{MULTI_GPU}')
    p = register_hyperparameter_args(p)
    args = p.parse_args(argv)
    if args.config is not None and args.resume is not None:
        raise ValueError('only specify a config file or a resume file but '
                         'not both')
    multi = [flag for flag, on in (
        ('--n_devices', args.n_devices is not None and args.n_devices > 1),
        ('--distributed', args.distributed),
        ('--coordinator', args.coordinator is not None),
        ('--num_processes', args.num_processes is not None),
        ('--process_id', args.process_id is not None)) if on]
    if multi:
        raise NotImplementedError(f"{', '.join(multi)}: multi-device "
                                  f"training waits for {MULTI_GPU}")
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

    ckpt_resume = None
    if args.resume is not None:
        run_dir, ckpt_resume = resume_target(args.resume)
        config_file = run_dir / 'config.yaml'
    else:
        config_file = args.config
        run_dir = None

    seed = args.seed if args.seed is not None else 0
    config = merge_config_and_args(load_file(config_file), args)
    maybe_make_synthetic(config)

    data_module = data_module_from_config(config)
    model = model_from_config(config, device=device, seed=seed)

    wandb_config = dict(config.get('wandb', {}))
    if args.debug:
        wandb_config['mode'] = 'disabled'
        wandb_config['name'] = 'debug_run'

    output_dir = Path(config['training']['output_dir'])
    output_dir.mkdir(parents=True, exist_ok=True)

    if args.resume is None:
        run_id = generate_run_id()
        wandb_config['id'] = run_id
        name = wandb_config.get('name', 'run').replace(' ', '-')
        run_dir = output_dir / f'{name}_{run_id}'
        config.setdefault('resume', {})['run_id'] = run_id
        run_dir.mkdir(parents=True, exist_ok=True)
        print('Results are being written to:', run_dir)
        dump_file(config, run_dir / 'config.yaml')
    else:
        wandb_config['id'] = config.get('resume', {}).get('run_id',
                                                          'resumed')
        wandb_config['resume'] = 'must'

    wandb_config['save_dir'] = str(output_dir)
    logger = MetricsLogger(run_dir, wandb_config, full_config=config)
    trainer = Trainer(config, run_dir, logger=logger, debug=args.debug,
                      seed=seed, device=device)
    try:
        trainer.fit(model, data_module, resume_from=ckpt_resume)
    finally:
        logger.finish()
    return run_dir


if __name__ == '__main__':
    main()
