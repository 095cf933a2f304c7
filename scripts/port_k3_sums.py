"""How K3 (the port's pp-message backward kernel) sums its weight
gradients, measured on a CUDA card at `chip_smoke.py`'s training shape
(B=32 pockets of 230 atoms in 256 slots, K=16, S=128, V=16, 3 GVPs, fp32).

    python3 -m scripts.port_k3_sums [--repeats 4]

Builds `pharmaforge_tpu_torch/csrc/pp_message_bwd.cu` as it is (each
chunk's 32-row fp32 sums added to an fp64 buffer) and a copy with every
`double` made `float` (the same sums added to an fp32 buffer in atomic
order). Prints, for the fp32 plain version and for each variant and
repeat, every gradient leaf's max |a - b| / (2e-5 + 2e-4 |b|) against
the plain version run in fp64 and in fp32 (1 is the edge of the fp32
tolerance), then each variant's time per call from a CUDA-graph replay,
with the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs
from pharmaforge_tpu_torch.ops import _build
from pharmaforge_tpu_torch.ops import pp_message as ppm


def build_fp32_sums() -> ctypes.CDLL:
    """The kernel with an fp32 weight-gradient buffer."""
    src = (_build.CSRC_DIR / "pp_message_bwd.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "pp_message_bwd_fp32sums.cu"
    cu.write_text(src.replace("double", "float"))
    lib = cu.with_suffix(".so")
    subprocess.run([_build.nvcc_path(), *_build.nvcc_flags("pp_message_bwd"),
                    "-o", str(lib), str(cu)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    out.pp_message_bwd_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
        + [ctypes.c_void_p] * 4)
    out.pp_message_bwd_launch.restype = ctypes.c_int
    out.pp_message_bwd_grads_size.argtypes = [ctypes.c_int] * 6
    out.pp_message_bwd_grads_size.restype = ctypes.c_int
    return out


def fp32_sums_launch(lib):
    """`ppm._launch_bwd` for the fp32-buffer build."""
    def launch(d, saved, ds, dv):
        tab_s, tab_v, idx, mask, rterm, dirterm, rbf, xdir, packed = saved
        dev = tab_s.device
        ds, dv = ds.float().contiguous(), dv.float().contiguous()
        d_tab_s = torch.zeros((d.b, d.p, d.s), device=dev)
        d_tab_v = torch.zeros((d.b, d.p, 3, d.h0), device=dev)
        d_w = torch.zeros(lib.pp_message_bwd_grads_size(
            d.s, d.v, d.h0, d.hj, d.r, d.n_layers), device=dev)
        err = lib.pp_message_bwd_launch(
            0, tab_s.data_ptr(), tab_v.data_ptr(), idx.data_ptr(),
            mask.data_ptr(), rterm.data_ptr(), dirterm.data_ptr(),
            rbf.data_ptr(), xdir.data_ptr(), packed.data_ptr(),
            ds.data_ptr(), dv.data_ptr(), d.b, d.p, d.g, d.copies, d.nd,
            d.k, d.s, d.v, d.h0, d.hj, d.r, d.n_layers, d_tab_s.data_ptr(),
            d_tab_v.data_ptr(), d_w.data_ptr(), ppm._stream(dev))
        cs.check(err == 0, f"fp32-buffer K3 launch failed: CUDA error {err}")
        return d_tab_s, d_tab_v, d_w
    return launch


def units(got, want) -> list:
    tol = cs.PPBWD_TOL["float32"]
    return [float(((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs()))
                  .max()) for g, w in zip(got, want)]


def show(name: str, row: list) -> None:
    print(f"{name:22s} max {max(row):.4f} (leaf {row.index(max(row))}) | "
          + " ".join(f"{x:.3g}" for x in row), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("port_k3_sums: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=4)
    repeats = parser.parse_args().repeats
    dev = torch.device("cuda")
    ppm._bwd_launcher()                  # builds the kernel as it is
    variants = {"fp64 buffer": ppm._launch_bwd,
                "fp32 buffer": fp32_sums_launch(build_fp32_sums())}
    args, kw = cs.pp_case(dev, dtype="float32", table_dtype=torch.float32,
                          **cs.PPBWD_TRAIN)
    gen = torch.Generator(device=dev).manual_seed(5)
    b, nd = args[0].shape[0], args[2].mask.shape[1]
    cot = (torch.randn(b, nd, kw["scalar_size"], generator=gen, device=dev),
           torch.randn(b, nd, kw["vector_size"], 3, generator=gen,
                       device=dev))
    p64 = cs.ppbwd_want(args, kw, "float32", cot)
    p32 = cs.ppbwd_grads(args, kw, False, cot)
    print(f"{cs.card()}; {len(p64)} gradient leaves, max |b| per leaf "
          + " ".join(f"{float(w.abs().max()):.3g}" for w in p64), flush=True)
    show("plain fp32 vs fp64", units(p32, p64))
    try:
        for rep in range(repeats):
            for name, launch in variants.items():
                ppm._launch_bwd = launch
                got = cs.ppbwd_grads(args, kw, True, cot)
                show(f"{name} #{rep} vs fp64", units(got, p64))
                show(f"{name} #{rep} vs fp32", units(got, p32))
        pre_s, planes, edge, chain = args
        w = ppm.split_weights(chain, kw["scalar_size"], kw["rbf_dim"])
        d = ppm._dims(pre_s, planes, edge, w, **kw)
        with torch.no_grad():
            saved = ppm.kernel_inputs(d, pre_s, planes, edge, w)
        for name in [*variants, *variants]:
            ms = cs.graph_ms(lambda: variants[name](d, saved, *cot),
                             calls=10, replays=3)
            print(f"K3 {name}: {ms:.4f} ms per call (graph replay)",
                  flush=True)
    finally:
        ppm._launch_bwd = variants["fp64 buffer"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
