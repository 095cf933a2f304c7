"""Repo-root-relative path resolution.

Port of `pharmaforge_tpu/utils/relative_paths.py` (reference
utils/relative_paths.py).
"""

from pathlib import Path

import pharmaforge_tpu_torch


def fix_relative_path(path: str) -> str:
    """`path` taken relative to the root of the repository."""
    root_dir = Path(pharmaforge_tpu_torch.__file__).parent.parent
    return str(root_dir / path)
