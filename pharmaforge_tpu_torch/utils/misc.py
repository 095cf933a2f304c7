"""Small host-side utilities (reference utils/unorganized_utils.py).

Port of `pharmaforge_tpu/utils/misc.py`: the type maps, the pharmacophore
xyz writer and the matmul precision policy of the CLIs. The JAX side's
`setup_jax` (compile cache, platform) has no counterpart: the device is
the CLIs' `--device`.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pharmaforge_tpu_torch.constants import TYPE_IDX_TO_ELEM

# --matmul_precision -> (torch float32 matmul precision, cuDNN TF32)
MATMUL_PRECISIONS = {
    "float32": ("highest", False),
    "tensorfloat32": ("high", True),
    "bfloat16": ("medium", False),
}


def set_matmul_precision(precision: str = "float32") -> None:
    """The float32 matmul policy: 'float32' keeps TF32 off (the port's
    default, `pharmaforge_tpu_torch/__init__.py`), 'tensorfloat32' lets
    matmuls and cuDNN use TF32, 'bfloat16' lets matmuls use bf16
    (`torch.set_float32_matmul_precision("medium")`)."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision {precision!r}: one of "
                         f"{sorted(MATMUL_PRECISIONS)}")
    matmul, cudnn = MATMUL_PRECISIONS[precision]
    torch.set_float32_matmul_precision(matmul)
    torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def matmul_precision(precision: str = "float32"):
    """`set_matmul_precision` inside the block, the previous policy
    after it."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    set_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def get_prot_atom_ph_type_maps(dataset_config: dict):
    """Element/type name -> index maps (reference
    utils/unorganized_utils.py:97-106). `other` maps one past the known
    elements and is dropped downstream."""
    prot_elements = dataset_config["prot_elements"]
    prot_element_map: Dict[str, int] = {
        element: idx for idx, element in enumerate(prot_elements)}
    prot_element_map["other"] = len(prot_elements)

    ph_types = dataset_config["ph_type_map"]
    ph_type_map: Dict[str, int] = {
        element: idx for idx, element in enumerate(ph_types)}
    return prot_element_map, ph_type_map


def write_pharmacophore_file(coords_list: Sequence[np.ndarray],
                             atom_types_list: Sequence[Sequence[int]],
                             pharm_type_map: list,
                             filename: Optional[str] = None):
    """Multi-frame xyz-style pharmacophore writer (reference
    utils/unorganized_utils.py:111-128)."""
    out = ""
    for coords, atom_types in zip(coords_list, atom_types_list):
        if len(coords) != len(atom_types):
            raise ValueError(f"{len(coords)} coordinates for "
                             f"{len(atom_types)} types")
        elems = [TYPE_IDX_TO_ELEM[int(i)] for i in atom_types]
        out += f"{len(coords)}\n"
        for i in range(len(coords)):
            out += (f"{elems[i]} {coords[i, 0]:.3f} "
                    f"{coords[i, 1]:.3f} {coords[i, 2]:.3f}\n")

    if filename is None:
        return out
    Path(filename).write_text(out)
    return None
