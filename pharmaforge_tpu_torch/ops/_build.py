"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled with
`nvcc` for Hopper (`sm_90a`) into
`build/pharmaforge_tpu_torch/<name>-<hash>.so` at the checkout's root,
keyed on the source bytes and that kernel's flags, and loaded with
`ctypes`. The first call in a fresh checkout builds; later calls reuse
the library. A missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "pharmaforge_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# per-kernel flags. knn_select: --fmad=false, no multiply-add contraction,
# so its distances round after every operation exactly as the plain
# version does (it is held bit-equal). pp_message is held to a tolerance
# and keeps fused multiply-adds.
KERNEL_FLAGS = {"knn_select": ("--fmad=false",), "pp_message": (),
                "pp_message_bwd": ()}


def nvcc_flags(name: str) -> tuple:
    """The full nvcc flag list for `csrc/<name>.cu`."""
    return NVCC_FLAGS + KERNEL_FLAGS[name]


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, under $CUDA_HOME, or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed on its source and flags."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(nvcc_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library already exists. The
    compiler's output (with `-Xptxas -v`: registers, shared memory and
    spills per kernel) is kept beside the library as `<name>-<hash>.log`."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`'s library, once per
    process."""
    return ctypes.CDLL(str(build(name)))
