"""Offline preprocessing CLI of the port: CrossDocked2020 -> training tensors.

    python -m pharmaforge_tpu_torch.cli.process_crossdocked \
        --config configs/dev.yml [--max_workers N]

Port of the JAX package's `process_crossdocked.py`, flag for flag
(reference process_crossdocked.py): reads `dataset.raw_data_dir` (its
`types/it2_tt_v1.3_0_test*types` files and the `CrossDocked2020/` tree),
extracts every label-1 pair in a worker pool
(`preprocessing/crossdocked.py::getfeatures`), drops the pairs whose
ligand failed to parse or which have no pharmacophore points, and writes
one split directory per types file under `dataset.processed_data_dir`.
The config is read with `config/yaml_io.py`. It needs the host-side
chemistry toolkits (RDKit, Biopython, OpenBabel) and the `pharmit` binary
on PATH. The pool forks, so neither this module nor what it imports
initialises CUDA.
"""

from __future__ import annotations

import multiprocessing
from functools import partial
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from pharmaforge_tpu_torch.config.cmdline import ArgumentParser
from pharmaforge_tpu_torch.config.yaml_io import load_file
from pharmaforge_tpu_torch.preprocessing.crossdocked import (
    getfeatures,
    read_types_files,
    write_processed_dataset,
)


def parse_arguments(argv: Optional[Sequence[str]] = None):
    parser = ArgumentParser(prog="pharmaforge_tpu_torch.cli."
                                 "process_crossdocked")
    parser.add_argument("--config", help="Path to config file", required=True,
                        type=Path)
    parser.add_argument("--max_workers", type=int, default=None,
                        help="Number of workers for multiprocessing, defaults "
                             "to all available.")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    """Preprocess as the command line `argv` says; returns the processed
    data directory."""
    args = parse_arguments(argv)
    config = load_file(args.config)

    crossdocked_path = config["dataset"]["raw_data_dir"]
    crossdocked_data_dir = Path(crossdocked_path) / "CrossDocked2020"
    output_path = config["dataset"]["processed_data_dir"]
    dataset_size = config["dataset"].get("dataset_size")

    allinputs = read_types_files(crossdocked_path, dataset_size)
    if not allinputs:
        raise FileNotFoundError(
            f"no types files matching it2_tt_v1.3_0_test*types under "
            f"{crossdocked_path}/types")

    getfeatures_partial = partial(
        getfeatures, crossdocked_data_dir=crossdocked_data_dir,
        pocket_cutoff=config["dataset"]["pocket_cutoff"])

    try:
        from tqdm.contrib.concurrent import process_map
    except ImportError:
        process_map = None
    for fname, inputs in allinputs:
        chunksize = 20
        print(f"processing types file {fname}")

        if process_map is not None:
            workers = ({"max_workers": args.max_workers} if args.max_workers
                       else {})
            phdata = process_map(getfeatures_partial, inputs,
                                 chunksize=chunksize, **workers)
        else:
            with multiprocessing.Pool(args.max_workers) as pool:
                phdata = pool.map(getfeatures_partial, inputs, chunksize)

        n_samples = len(phdata)
        # drop unparseable ligands, then examples with no pharmacophore points
        phdata = [ex for ex in phdata if ex[2]]
        n_bad_ligands = n_samples - len(phdata)
        phdata = [ex for ex in phdata if isinstance(ex[3][0], np.ndarray)]
        n_bad_pharm = n_samples - len(phdata) - n_bad_ligands

        print(f"{n_samples} samples in {fname}")
        print(f"failed to parse {n_bad_ligands} ligands and failed to obtain "
              f"pharmacophore points for {n_bad_pharm} examples")
        print(f"processed {len(phdata)} examples")

        write_processed_dataset(
            output_path, fname, phdata,
            pocket_element_map=config["dataset"]["prot_elements"],
            min_pharm_centers=config["dataset"]["min_pharm_centers"])
    return Path(output_path)


if __name__ == "__main__":
    main()
