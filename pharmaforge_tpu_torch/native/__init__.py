"""Native (C++) host-side batch packer.

Port of `pharmaforge_tpu/native/__init__.py`; `packer.cpp` is a byte copy
of the JAX package's source. It is compiled on first use with `g++ -O3
-shared -fPIC -std=c++17` into
`build/pharmaforge_tpu_torch/packer-<hash>.so` at the checkout's root
(beside the CUDA kernels' libraries, `ops/_build.py`), keyed on the
source bytes, and loaded through ctypes. Every entry point has a numpy
fallback with the same values, used where g++ is missing or the build
fails, and when `PHARMAFORGE_NATIVE=0` (read on every call);
`native_available()` reports which path is live.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from pharmaforge_tpu_torch.ops._build import BUILD_DIR

_SRC = Path(__file__).parent / "packer.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Where `packer.cpp` builds to, keyed on its bytes and the flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"packer-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile `packer.cpp` unless its library exists. The compiler writes
    a name of its own process and the library is renamed into place, so
    builds racing in several processes never leave a partial file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    """The packer's library, built if needed, once per process; None when
    it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pack_batch.restype = ctypes.c_int
    lib.pack_batch.argtypes = [f32p, i32p, i64p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               f32p, f32p, u8p]
    lib.pack_batch_gather.restype = ctypes.c_int
    lib.pack_batch_gather.argtypes = [f32p, i32p, i64p, i64p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, f32p, f32p, u8p]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    if os.environ.get("PHARMAFORGE_NATIVE", "1") == "0":
        return None
    return _load()


def native_available() -> bool:
    return _lib() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _outputs(b: int, slots: int, n_classes: int):
    return (np.zeros((b, slots, 3), np.float32),
            np.zeros((b, slots, n_classes), np.float32),
            np.zeros((b, slots), np.uint8))


def pack_batch(pos_flat: np.ndarray, feat_flat: np.ndarray,
               spans: np.ndarray, slots: int, n_classes: int):
    """Pack contiguous spans into (x [B,slots,3], h [B,slots,C], mask [B,slots]).

    Native when available; numpy fallback otherwise. `spans` is int64 [B,2].
    """
    pos_flat = np.ascontiguousarray(pos_flat, np.float32)
    feat_flat = np.ascontiguousarray(feat_flat, np.int32)
    spans = np.ascontiguousarray(spans, np.int64)
    b = spans.shape[0]
    out_x, out_h, out_mask = _outputs(b, slots, n_classes)

    lib = _lib()
    if lib is not None:
        rc = lib.pack_batch(
            _ptr(pos_flat, ctypes.c_float), _ptr(feat_flat, ctypes.c_int32),
            _ptr(spans, ctypes.c_int64), b, slots, n_classes,
            _ptr(out_x, ctypes.c_float), _ptr(out_h, ctypes.c_float),
            _ptr(out_mask, ctypes.c_uint8))
        if rc != 0:
            raise ValueError(f"a span exceeds the slot count {slots}")
        return out_x, out_h, out_mask.astype(bool)

    eye = np.eye(n_classes, dtype=np.float32)
    for i, (s, e) in enumerate(spans):
        n = e - s
        if n > slots or n < 0:
            raise ValueError(f"a span exceeds the slot count {slots}")
        out_x[i, :n] = pos_flat[s:e]
        out_h[i, :n] = eye[feat_flat[s:e]]
        out_mask[i, :n] = 1
    return out_x, out_h, out_mask.astype(bool)


def pack_batch_gather(pos_flat: np.ndarray, feat_flat: np.ndarray,
                      idx_flat: np.ndarray, offsets: np.ndarray,
                      slots: int, n_classes: int):
    """Gather-based packing for subsample augmentation.

    Row i packs elements idx_flat[offsets[i]:offsets[i+1]].
    """
    pos_flat = np.ascontiguousarray(pos_flat, np.float32)
    feat_flat = np.ascontiguousarray(feat_flat, np.int32)
    idx_flat = np.ascontiguousarray(idx_flat, np.int64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    b = offsets.shape[0] - 1
    out_x, out_h, out_mask = _outputs(b, slots, n_classes)

    lib = _lib()
    if lib is not None:
        rc = lib.pack_batch_gather(
            _ptr(pos_flat, ctypes.c_float), _ptr(feat_flat, ctypes.c_int32),
            _ptr(idx_flat, ctypes.c_int64), _ptr(offsets, ctypes.c_int64),
            b, slots, n_classes,
            _ptr(out_x, ctypes.c_float), _ptr(out_h, ctypes.c_float),
            _ptr(out_mask, ctypes.c_uint8))
        if rc != 0:
            raise ValueError(f"a row exceeds the slot count {slots}")
        return out_x, out_h, out_mask.astype(bool)

    eye = np.eye(n_classes, dtype=np.float32)
    for i in range(b):
        sel = idx_flat[offsets[i]:offsets[i + 1]]
        n = len(sel)
        if n > slots:
            raise ValueError(f"a row exceeds the slot count {slots}")
        out_x[i, :n] = pos_flat[sel]
        out_h[i, :n] = eye[feat_flat[sel]]
        out_mask[i, :n] = 1
    return out_x, out_h, out_mask.astype(bool)
