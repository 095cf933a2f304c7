#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`pharmaforge_tpu_torch`).

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # also traces chains (dev, full scale
                                     # with and without the correction) and
                                     # a train step with torch.profiler
    python3 chip_smoke.py --profile-only DIR  # only the build, those
                                     # traces and the train phase; each
                                     # kernel table by name into DIR

Phases, one line each; any failure raises and the script exits non-zero:

1. build     -- compile every CUDA kernel of the sampling and training
                paths from `pharmaforge_tpu_torch/csrc` (nvcc, sm_90a; one
                nvcc per source, all started together);
2. knn       -- the pf k-NN kernel (K1) against its plain PyTorch
                versions on the card, through both entries: `knn_select`
                (idx, dist and xg bit-equal) and `knn_pf_edges` (idx and
                mask bit-equal, x_dir, -x_dir and d_rbf within 2e-6) at
                the sampling shape and at edge cases (ties, a masked pharm
                row, fewer valid atoms than k, an odd batch, k in
                {1, 5, 8, 40}, P in {64, 1,024, 1,500}, F=12); device
                times (CUDA-graph replay between CUDA events) of both
                entries, of the selection followed by the 16 PyTorch ops
                it replaces (also eagerly), of an empty kernel (the launch
                floor), of the plain version and of `torch.topk`;
3. golden    -- the frozen chains `tests/golden/trajectory_{radius,knn}.npz`
                on the card within 2e-3, the knn chain through K1 exactly T
                times;
4. main      -- the dev model at full width (n_convs=2, 128 scalars, 16
                vectors, T=100, fp32, random weights from a seed) sampling
                8 synthetic 230-atom pockets x 30 samples through
                `PocketSampler.sample_stacked` (B=240; the JAX package's
                dataflow: the first conv is the compact one, its prot
                encoder runs once per pocket): finite output, zero padded
                slots, exactly 100 K1 and no K2 launches per chain,
                samples/s; and 1 pocket x 8 samples on the CPU and the card
                with the same injected noise, within 2e-3;
5. pp        -- the fused pp-message kernel (K2) against its plain version
                on the card, in bf16 and fp32: the sampling shape (B=120 =
                4 pockets x 30 copies, P=Nd=230, K=16, S=128, V=16, 3
                GVPs), the compact tail (copies=1, Nd=40), the pocket-copy
                correction's two layouts (the clean pass: G=4, Nd=3,680,
                K=1; the dirty pass: B=120 rows of the 40 pf-listed atoms,
                Nd=40 x K_out, K=1, its masks as the correction builds
                them), the training batch (B=32, P=Nd=192 and 256), and
                edge cases (hidden width V+1, a fully masked destination,
                K=1, an odd batch, every slot an edge, Nd=233, K=64,
                widths 72/8/9, 5 GVPs), two calls bit-equal; device times
                (graph replay) of the wrapper call and of the kernel alone
                in bf16 and fp32 at the sampling shape and in fp32 at the
                training shape, and of the wrapper call in bf16 in the
                compact, clean and dirty layouts, each beside its bound, of
                the plain version, and the eager time;
6. fullscale -- the JAX package's full-scale sampling path: the
                reference-size model (n_convs=4, T=1000, endpoint, bf16
                edge chains, same widths, random weights from a seed) with
                the compact prot tail and the pocket-copy correction
                (`pp_k_out` probed by `PocketSampler`), sampling 4
                synthetic 230-atom pockets x 30 through
                `PocketSampler.sample_stacked` (B=120): finite zero-padded
                output, a probed k_out > 0, exactly 1,000 correction
                passes, 3,000 K2 and 1,000 K1 launches per chain,
                samples/s over timed chains after a warm-up; and the same
                model in fp32 over 20 steps, 1 pocket x 8 (correction on),
                on the card and on the CPU with the same injected noise,
                within 2e-3;
   fullwidth -- the same model with the compact tail off (no correction),
                T=100, one timed chain: exactly 200 K2 and 100 K1 launches,
                samples/s, card vs CPU as above; and its fp32 chain over 20
                steps held against the fullscale path's on the card (same
                weights and noise) within 2e-3, the bf16 difference
                printed beside it;
7. ppbwd     -- the pp-message backward kernel (K3) against autograd
                through the plain version on the card: the training shape
                (B=32 pockets of 230 atoms in 256 slots, K=16, S=128,
                V=16, 3 GVPs) in fp32 and bf16, copies=3, hidden width
                V+1, a fully masked destination (whose cotangent must reach
                no gradient), a source repeated in one list and across
                tiles, K=1, an odd batch; device times of K3 (graph
                replay), of K2 + K3 forward and backward, of the plain
                version's backward, and the bound;
8. train     -- `Trainer.fit` at full scale: the reference-size model in
                fp32 with dropout 0.1 (bench.py:456-465) on a synthetic
                3 x 64-pocket dataset (200-230 atoms, seed 11), batch 32,
                two epochs with one sampling evaluation, then a third
                epoch resumed from 'last': exactly 1 K1, 2 K2 and 2 K3
                launches per optimizer step, finite losses, a bit-equal
                checkpoint round trip, train steps/s; and one fp32 step at
                dropout 0 on the card and on the CPU from the same weights
                and injected noise (loss within rtol 1e-5, gradients per
                leaf within 2e-4 max|b| + 2e-5).

Then the card's name and power limit, the `kernels` JSON line, and the
final `{"ok": true, ...}` line. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHAIN_TOL = 2e-3          # the JAX package's full-chain tolerance
# the JAX package's fused-vs-unfused conv output tolerance
# (tests/test_pp_fused.py:143-148)
CONV_TOL = dict(rtol=2e-4, atol=2e-5)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) op/s,
# dense bf16 tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS = 67e12
PEAK_BF16_OPS = 989e12
KERNELS = ("knn_select", "pp_message", "pp_message_bwd")
# `--profile-only DIR`: where each profile's full kernel table goes
PROFILE_TABLES = None


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    """`name, power.limit` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 100, warmup: int = 5) -> float:
    """Mean milliseconds per call over `reps` back-to-back calls, timed
    with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Milliseconds per call of `fn` on the device alone: `calls` calls
    captured in one CUDA graph, replayed `replays` times between CUDA
    events, so host dispatch does not pace the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ------------------------------------------------------------------ build

# An empty kernel, the launch floor the knn phase times beside K1. It is
# not a kernel of the port: the script builds it beside the port's
# libraries, with their flags.
FLOOR_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def build_floor() -> Path:
    """Compile FLOOR_SRC unless its library (keyed on the source) exists."""
    from pharmaforge_tpu_torch.ops import _build
    key = hashlib.sha256(FLOOR_SRC.encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"launch_floor-{key}.so"
    if out.exists():
        return out
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".cu")
    src.write_text(FLOOR_SRC)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    check(proc.returncode == 0, f"nvcc failed for the empty kernel:\n"
                                f"{proc.stderr}")
    return out


@functools.cache
def floor_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_floor()))
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def phase_build() -> None:
    from pharmaforge_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        floor = pool.submit(build_floor)
        libs = list(pool.map(_build.build, KERNELS))
        floor.result()
    secs = time.perf_counter() - t0
    for name, lib in zip(KERNELS, libs):
        ptxas = [ln.strip() for ln in
                 lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
        print(f"build: {name}.cu -> {lib.name}; {' | '.join(ptxas)}",
              flush=True)
    print(f"build: {len(KERNELS)} kernels and the empty kernel in "
          f"{secs:.2f} s", flush=True)


# -------------------------------------------------------------------- knn

def synthetic_pockets(n: int, atoms: int = 230):
    """`n` synthetic pockets (seeds 0..n-1), as `bench.py` makes them."""
    from pharmaforge_tpu_torch.data.synthetic import make_synthetic_pocket
    pockets = []
    for seed in range(n):
        px, elem = make_synthetic_pocket(np.random.default_rng(seed),
                                         np.zeros(3), atoms)
        pockets.append({"prot_x": px.astype(np.float32),
                        "prot_h": np.eye(11, dtype=np.float32)[elem]})
    return pockets


def knn_case(rng, b: int, f: int = 8, p: int = 230):
    """pharm centres near synthetic pocket atoms (pockets of p atoms before
    the generator's thinning, in p slots), with sizes 3..f."""
    pockets = synthetic_pockets(4, p)
    prot_x = np.zeros((b, p, 3), np.float32)
    prot_mask = np.zeros((b, p), bool)
    for i in range(b):
        px = pockets[i % len(pockets)]["prot_x"]
        prot_x[i, :len(px)] = px
        prot_mask[i, :len(px)] = True
    pharm_x = rng.normal(scale=4.0, size=(b, f, 3)).astype(np.float32)
    pharm_mask = np.arange(f)[None, :] < rng.integers(3, f + 1, b)[:, None]
    return pharm_x, pharm_mask, prot_x, prot_mask


# K1's cases against its plain versions: the sampling shape, ties, a masked
# pharm row, fewer valid atoms than k, an odd batch, the register variants'
# edges (P=64, P=1,024), the shared-memory variant (P=1,500), k above 32
# (the passes in two rounds) and more pharm slots than a block has warps
KNN_EDGE_K = (1, 5, 8)
KNN_SHAPES = (("odd B=3 k=5", 3, 8, 230, 5), ("P=64 B=4 k=5", 4, 8, 64, 5),
              ("P=1024 B=4 k=5", 4, 8, 1024, 5),
              ("P=1500 B=4 k=5", 4, 8, 1500, 5), ("k=40 B=2", 2, 8, 230, 40),
              ("F=12 B=2 k=5", 2, 12, 230, 5))
# knn_pf_edges' geometry against its plain version on the card: the fp32
# sum of three squares, sqrt and expf may round an ulp apart between the
# kernel and PyTorch's CUDA ops; near d = 15 an ulp of d is ~1e-6, and the
# RBF's slope (at most 0.86 / sigma) carries it into d_rbf
KNN_GEOM_ATOL = 2e-6
# K1 selection only, at B=240 F=8 P=230 k=5, in its earlier design (one
# block a batch row staging the pocket in shared memory, ten shuffles a
# pass), by CUDA-graph replay on an H100 80GB HBM3 at 700 W (PERF.md)
KNN_EARLIER_MS = 0.00557


def knn_cases(rng) -> list:
    """(name, (pharm_x, pharm_mask, prot_x, prot_mask), k) for K1."""
    cases = [("bench B=240 k=5", knn_case(rng, 240), 5)]
    px, pm, qx, qm = (a.copy() for a in knn_case(rng, 4))
    qx[0, 7] = qx[0, 3]               # exact duplicate coordinates: ties
    qx[1, 10] = qx[1, 2]
    pm[1, :] = False                  # a masked-out pharm row
    qm[2, 3:] = False                 # fewer valid atoms than k
    for k in KNN_EDGE_K:
        cases.append((f"edge B=4 k={k}", (px, pm, qx, qm), k))
    for name, b, f, p, k in KNN_SHAPES:
        cases.append((name, knn_case(rng, b, f=f, p=p), k))
    return cases


def knn_check(name: str, args, k: int) -> float:
    """`knn_select` bit-equal to its plain version; `knn_pf_edges` with idx
    and mask bit-equal and the geometry within KNN_GEOM_ATOL of its plain
    version. Each entry must launch the kernel once. Returns the geometry's
    max abs error."""
    from pharmaforge_tpu_torch.ops import knn_select as ks
    before = ks.launches
    got = ks.knn_select(*args, k)
    want = ks.knn_select_reference(*args, k)
    torch.cuda.synchronize()
    check(ks.launches == before + 1, f"knn {name}: knn_select launched "
                                     f"{ks.launches - before} kernels")
    for label, g, w in zip(("idx", "dist", "xg"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"knn {name}: {label} {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        check(torch.equal(g, w), f"knn {name}: {label} differs from "
                                 f"the plain version")
    got = ks.knn_pf_edges(*args, k)
    want = ks.knn_pf_edges_reference(*args, k)
    torch.cuda.synchronize()
    check(ks.launches == before + 2, f"knn {name}: knn_pf_edges did not "
                                     f"launch the kernel once")
    worst = 0.0
    for label, g, w in zip(("idx", "mask", "x_dir", "x_dir_fp", "d_rbf"),
                           got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"knn {name}: pf {label} {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        if label in ("idx", "mask"):
            check(torch.equal(g, w), f"knn {name}: pf {label} differs from "
                                     f"the plain version")
            continue
        err = float((g - w).abs().max())
        check(err <= KNN_GEOM_ATOL, f"knn {name}: pf {label} max |err| "
                                    f"{err:.3e} > {KNN_GEOM_ATOL}")
        worst = max(worst, err)
    return worst


def knn_old_sequence(pharm_x, pharm_mask, prot_x, prot_mask, k):
    """The pf edges as the denoiser built them before the geometry moved
    into the kernel: the selection-only launch, then 16 PyTorch ops."""
    from pharmaforge_tpu_torch.ops import knn_select as ks
    from pharmaforge_tpu_torch.ops.geometry import pair_geometry
    idx, dist, xg = ks.knn_select(pharm_x, pharm_mask, prot_x, prot_mask, k)
    x_dir, d_rbf = pair_geometry(pharm_x, xg)
    return idx.long(), dist < 1e30, x_dir, -x_dir, d_rbf


def phase_knn(dev) -> dict:
    """K1 against its plain versions in every case, then its times at the
    sampling shape. In the kernels line `ms` is `knn_pf_edges`, the main
    path's call; `plain_ms` its plain version `knn_pf_edges_reference`;
    `library_ms` `torch.topk` on a precomputed d2, the selection step
    alone, since no single PyTorch call computes the pf edges;
    `selection_ms` is `knn_select`, the function the earlier design
    computed (KNN_EARLIER_MS, printed beside it)."""
    from pharmaforge_tpu_torch.ops import knn_select as ks
    from pharmaforge_tpu_torch.ops.geometry import RBF_DIM
    cases = knn_cases(np.random.default_rng(0))
    errs = {}
    for name, arrs, k in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrs]
        errs[name] = knn_check(name, args, k)

    args = [torch.from_numpy(a).to(dev) for a in cases[0][1]]
    b, f = cases[0][1][1].shape
    p, k = cases[0][1][3].shape[1], cases[0][2]

    floor = floor_library()
    check(floor.empty_launch(1, 32, torch.cuda.current_stream().cuda_stream)
          == 0, "knn: the empty kernel did not launch")

    def empty(blocks, threads):
        return lambda: floor.empty_launch(
            blocks, threads, torch.cuda.current_stream().cuda_stream)

    before = ks.launches
    times = {
        "selection": graph_ms(lambda: ks.knn_select(*args, k)),
        "fused": graph_ms(lambda: ks.knn_pf_edges(*args, k)),
        "old": graph_ms(lambda: knn_old_sequence(*args, k)),
        "floor": graph_ms(empty(1, 32)),
        "floor_grid": graph_ms(empty(-(-b * f // 4), 128)),
        "fused_eager": cuda_ms(lambda: ks.knn_pf_edges(*args, k)),
        "old_eager": cuda_ms(lambda: knn_old_sequence(*args, k)),
        "plain": graph_ms(lambda: ks.knn_pf_edges_reference(*args, k)),
    }
    ks.launches = before       # timing launches are not the main path's
    d2 = torch.cdist(args[0], args[2]) ** 2
    library_ms = graph_ms(lambda: torch.topk(d2, k, largest=False))
    # least time for the same work (the fused entry): inputs read once,
    # outputs written once (idx 8 B, mask 1, x_dir and x_dir_fp 12 each,
    # d_rbf 4 RBF_DIM per slot); the distances and passes, then 17
    # operations of geometry and 5 per RBF value a slot
    out_slot = 8 + 1 + 12 + 12 + 4 * RBF_DIM
    n_bytes = b * f * 13 + b * p * 13 + b * f * k * out_slot
    n_ops = b * f * p * (8 + k) + b * f * k * (17 + 5 * RBF_DIM)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_OPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"knn: {len(cases)} cases, knn_select bit-equal to its plain "
          f"version and knn_pf_edges' idx and mask bit-equal, geometry max "
          f"abs err {json.dumps(errs)} (tolerance {KNN_GEOM_ATOL}); B={b} "
          f"F={f} P={p} k={k}, per call from CUDA-graph replay: selection "
          f"{times['selection']:.5f} ms (earlier design {KNN_EARLIER_MS}), "
          f"fused pf edges {times['fused']:.5f} ms, the earlier sequence "
          f"(selection + 16 PyTorch ops) {times['old']:.5f} ms, empty "
          f"kernel {times['floor']:.5f} ms (1 x 32 threads) / "
          f"{times['floor_grid']:.5f} ms (K1's grid, {-(-b * f // 4)} x 128); "
          f"eagerly back to back: fused {times['fused_eager']:.5f} ms, earlier "
          f"sequence {times['old_eager']:.5f} ms; plain pf edges "
          f"{times['plain']:.4f} ms; torch.topk on precomputed d2 "
          f"{library_ms:.5f} ms; bound {bound_ms:.6f} ms by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} ({n_bytes} B at "
          f"3.35 TB/s, {n_ops} ops at 67 TFLOP/s fp32)", flush=True)
    return {"name": "knn_select", "route": "cuda",
            "source": "pharmaforge_tpu_torch/csrc/knn_select.cu",
            "replaces": "pharmaforge_tpu/ops/pallas/knn_select.py:182",
            "max_abs_err": max(errs.values()), "ms": times["fused"],
            "fused_ms": times["fused"], "selection_ms": times["selection"],
            "floor_ms": times["floor"],
            "floor_grid_ms": times["floor_grid"],
            "earlier_sequence_ms": times["old"],
            "earlier_sequence_eager_ms": times["old_eager"],
            "eager_ms": times["fused_eager"], "plain_ms": times["plain"],
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# ----------------------------------------------------------------- golden

def golden_config(**overrides):
    """The fixtures' model (tests/test_trajectory_parity.py parity_config)."""
    from pharmaforge_tpu_torch.models.diffusion import DiffusionConfig
    kw = dict(n_timesteps=100, vector_size=8, n_convs=2,
              n_hidden_scalars=32, n_message_gvps=2, n_update_gvps=1,
              n_noise_gvps=2, message_norm="mean", ff_k=0, pf_k=0,
              pp_k_max=24, precision=1e-5)
    kw.update(overrides)
    return DiffusionConfig(**kw)


def phase_golden(dev) -> None:
    from pharmaforge_tpu_torch.data.batch import PharmComplexBatch
    from pharmaforge_tpu_torch.interop import load_reference_state_dict
    from pharmaforge_tpu_torch.ops import knn_select as ks
    report = []
    for name in ("radius", "knn"):
        data = np.load(ROOT / "tests" / "golden" / f"trajectory_{name}.npz")
        meta = json.loads(bytes(data["meta"]).decode())
        cfg = golden_config(**meta["config_overrides"])
        state = {k[len("sd::"):]: data[k] for k in data.files
                 if k.startswith("sd::")}
        model = load_reference_state_dict(state, cfg, device=dev)
        sizes, f, p = meta["pharm_sizes"], meta["f_slots"], meta["p_slots"]
        b, n = len(sizes), data["prot_x"].shape[0]
        prot_x = np.zeros((b, p, 3), np.float32)
        prot_h = np.zeros((b, p, 11), np.float32)
        prot_mask = np.zeros((b, p), bool)
        pharm_mask = np.arange(f)[None, :] < np.asarray(sizes)[:, None]
        prot_x[:, :n], prot_h[:, :n], prot_mask[:, :n] = \
            data["prot_x"], data["prot_h"], True
        batch = PharmComplexBatch(
            np.zeros((b, f, 3), np.float32), np.zeros((b, f, 6), np.float32),
            pharm_mask, prot_x, prot_h, prot_mask)
        noise = {"x_T": data["noise_x_T"], "h_T": data["noise_h_T"],
                 "pos": data["noise_pos"], "feat": data["noise_feat"]}
        before = ks.launches
        out = model.sample_given_receptor(
            batch, init_pharm_com=np.broadcast_to(data["init_com"], (b, 3)),
            visualize_trajectory=True, noise=noise)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        launched = ks.launches - before
        want = cfg.n_timesteps if cfg.pf_k else 0
        check(launched == want, f"golden {name}: {launched} knn_select "
                                f"launches, expected {want}")
        dev_max = 0.0
        for i, m in enumerate(sizes):
            # the port logs the initial frame first
            dev_max = max(
                dev_max,
                float(np.abs(out["traj_x"][1:, i, :m]
                             - data[f"ref_frames_{i}"]).max()),
                float(np.abs(out["pharm_x"][i, :m]
                             - data[f"ref_x_{i}"]).max()),
                float(np.abs(out["pharm_h"][i, :m]
                             - data[f"ref_h_{i}"]).max()))
        check(dev_max < CHAIN_TOL, f"golden {name}: max deviation "
                                   f"{dev_max:.3e} >= {CHAIN_TOL}")
        report.append(f"{name} max|dev| {dev_max:.3e}, "
                      f"{launched} knn launches")
    print(f"golden: {'; '.join(report)} (tolerance {CHAIN_TOL})",
          flush=True)


# ------------------------------------------------------------------- main

def dev_config():
    """configs/dev.yml's model (bench.py's dev workload)."""
    from pharmaforge_tpu_torch.models.diffusion import DiffusionConfig
    return DiffusionConfig(n_timesteps=100, n_convs=2, n_hidden_scalars=128,
                           vector_size=16, message_norm="mean",
                           n_message_gvps=3, n_update_gvps=2,
                           n_noise_gvps=4, pf_k=5, pp_k_max=16,
                           precision=1e-5)


def full_config():
    """The reference-size model of bench.py's full-scale workload
    (bench.py:229-239, 535): the dev widths at n_convs=4 and T=1000, with
    the endpoint parameterization and bf16 edge-message chains; the
    compact prot tail and the prot-encoder dedup on (the defaults), and
    the pocket-copy correction wherever `PocketSampler` probes it."""
    return dataclasses.replace(dev_config(), n_timesteps=1000, n_convs=4,
                               precision=1e-4, endpoint_param_feat=True,
                               endpoint_param_coord=True,
                               compute_dtype="bfloat16")


def fullwidth_config():
    """The full-scale model on the full-width path (the compact tail off,
    so no correction either), cut to T=100."""
    return dataclasses.replace(full_config(), n_timesteps=100,
                               compact_prot_tail=False)


def kernel_counters():
    """Kernel name -> (module, name of its wrapper's launch count)."""
    from pharmaforge_tpu_torch.ops import knn_select, pp_message
    return {"knn_select": (knn_select, "launches"),
            "pp_message": (pp_message, "launches"),
            "pp_message_bwd": (pp_message, "bwd_launches")}


def reset_launches() -> None:
    """Every kernel launch count and the correction-pass count to 0."""
    from pharmaforge_tpu_torch.models import conv
    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)
    conv.corrections = 0


def read_launches() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in kernel_counters().items()}


def expected_launches(cfg, corrected: bool = False) -> dict:
    """One chain of `cfg`: K1 once per denoiser call (knn pf), K2 once per
    middle conv (convs 1 .. n-2) per call, and once more where the second
    conv runs the pocket-copy correction (a clean and a dirty pass)."""
    t = cfg.n_timesteps
    return {"knn_select": t if cfg.pf_k else 0,
            "pp_message": t * (max(cfg.n_convs - 2, 0) + int(corrected))
            if cfg.fused_pp else 0,
            "pp_message_bwd": 0}


def stacked_k_out(model, pockets, atoms: int) -> int:
    """The `pp_k_out` that `PocketSampler.sample_stacked` probes for
    `pockets` in `atoms` slots (0 where the correction cannot engage)."""
    from pharmaforge_tpu_torch.training.sampling import probe_pp_k_out
    px = np.zeros((len(pockets), atoms, 3), np.float32)
    pm = np.zeros((len(pockets), atoms), bool)
    for i, pocket in enumerate(pockets):
        n = len(pocket["prot_x"])
        px[i, :n], pm[i, :n] = pocket["prot_x"], True
    return probe_pp_k_out(model, px, pm)


def chain_on(model, cfg, batch, noise, dev=None,
             capture: list | None = None) -> tuple:
    """The injected-noise chain of `model`'s weights under `cfg` for the
    one-pocket `batch`, on `dev` (the model's device by default), grouped
    with the probed `pp_k_out`: (final pharm_x, launch counts, correction
    passes, k_out). `capture` collects the second conv's prot output
    (scalars, vectors) of every step: the state the pocket-copy
    correction writes."""
    from pharmaforge_tpu_torch.models import conv
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    from pharmaforge_tpu_torch.training.sampling import probe_pp_k_out
    m = PharmacophoreDiffusion(cfg, device=dev or model.device)
    m.load_state_dict(model.state_dict())
    if capture is not None:
        m.dynamics.noise_predictor.conv_layers[1].register_forward_hook(
            lambda mod, args, out: capture.append(
                (out["prot"][0].cpu(), out["prot"][2].cpu())))
    k_out = probe_pp_k_out(m, batch.prot_x[:1], batch.prot_mask[:1])
    reset_launches()
    out = m.sample_given_receptor(batch, noise=noise,
                                  pocket_group_size=batch.batch_size,
                                  pp_k_out=k_out)
    if m.device.type == "cuda":
        torch.cuda.synchronize()
    return out["pharm_x"].cpu(), read_launches(), conv.corrections, k_out


def conv_state_err(want: list, got: list) -> tuple:
    """(max |got - want|, max of |got - want| - (atol + rtol |want|)) over
    the captured second-conv prot states of two chains, step by step."""
    check(len(want) == len(got) > 0, f"captured {len(want)} and "
                                     f"{len(got)} second-conv states")
    err, over = 0.0, -np.inf
    for w_step, g_step in zip(want, got):
        for w, g in zip(w_step, g_step):
            d = (g - w).abs()
            err = max(err, float(d.max()))
            over = max(over, float((d - CONV_TOL["atol"]
                                    - CONV_TOL["rtol"] * w.abs()).max()))
    return err, over


@contextlib.contextmanager
def correction_dropped(deltas: list):
    """A planted fault: every pocket-copy correction pass returns the clean
    aggregate alone (the dirty atoms' slots masked, so the scatter adds
    nothing). `deltas` collects, per pass, the largest |change| that the
    correction makes to the normalized aggregate."""
    from pharmaforge_tpu_torch.models.conv import GVPMultiEdgeConv
    real = GVPMultiEdgeConv._fused_pp_corrected

    def dropped(self, chain, h_src, v_src, ed, copies, corr):
        good = real(self, chain, h_src, v_src, ed, copies, corr)
        bad = real(self, chain, h_src, v_src, ed, copies, dict(
            corr, slot_mask=torch.zeros_like(corr["slot_mask"])))
        deltas.append(max(float((a - b).abs().max())
                          for a, b in zip(good[:2], bad[:2])))
        return bad

    GVPMultiEdgeConv._fused_pp_corrected = dropped
    try:
        yield
    finally:
        GVPMultiEdgeConv._fused_pp_corrected = real


def phase_sampling(name: str, dev, cfg, n_pockets: int, per_pocket: int,
                   atoms: int, timed: int, cmp_steps: int,
                   profile: bool = False, other=None) -> dict:
    """Drive `cfg` through `PocketSampler.sample_stacked`: a warm-up chain,
    then `timed` chains with every launch count set to 0 just before and
    read just after; then the same weights in fp32 over `cmp_steps` steps,
    1 pocket x 8, on the card and on the CPU with the same injected noise.
    `other` (DiffusionConfig overrides: the other sampling path) also
    holds that fp32 chain against the other path's on the card and prints
    the two paths' bf16 difference. Returns the launch counts of one timed
    chain."""
    from pharmaforge_tpu_torch.data.batch import tile_pocket
    from pharmaforge_tpu_torch.models import conv
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    from pharmaforge_tpu_torch.training.sampling import PocketSampler

    model = PharmacophoreDiffusion(
        cfg, device=dev, generator=torch.Generator().manual_seed(0))
    pockets = synthetic_pockets(n_pockets, atoms)
    sizes = np.random.default_rng(0).integers(3, 9, per_pocket)
    n_pharms = [sizes] * n_pockets
    sampler = PocketSampler(model, fixed_prot_slots=atoms, device=dev)
    gen = torch.Generator(device=dev)

    k_out = stacked_k_out(model, pockets, atoms)
    want = expected_launches(cfg, k_out > 0)
    want_corr = cfg.n_timesteps if k_out else 0
    gen.manual_seed(1)
    sampler.sample_stacked(pockets, n_pharms, gen)   # warm-up
    torch.cuda.synchronize()
    rates, launches = [], None
    for rep in range(timed):
        gen.manual_seed(2 + rep)
        reset_launches()
        t0 = time.perf_counter()
        res = sampler.sample_stacked(pockets, n_pharms, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        check(launches == want, f"{name}: launches per chain {launches}, "
                                f"expected {want}")
        check(conv.corrections == want_corr,
              f"{name}: {conv.corrections} correction passes per chain, "
              f"expected {want_corr}")
        rates.append(n_pockets * per_pocket / dt)
    out = sampler.last_output
    mask = out["pharm_mask"]
    check(out["pharm_x"].shape == (n_pockets * per_pocket, 8, 3),
          f"{name}: pharm_x shape {out['pharm_x'].shape}")
    check(all(np.isfinite(out[k]).all() for k in ("pharm_x", "pharm_h")),
          f"{name}: non-finite output")
    check(not out["pharm_x"][~mask].any() and not out["pharm_h"][~mask].any(),
          f"{name}: padded pharm slots are not zero")
    check(len(res) == n_pockets and all(
        [r.n_ph_centers for r in rs] == list(sizes) for rs in res),
        f"{name}: sample sizes differ from the request")

    # the same weights in fp32 and injected noise on the CPU and the card,
    # grouped, the correction on where this path probes it
    cmp_cfg = dataclasses.replace(cfg, n_timesteps=cmp_steps,
                                  compute_dtype="float32")
    batch = tile_pocket(pockets[0]["prot_x"], pockets[0]["prot_h"],
                        sizes[:8], max_prot=atoms)
    rng = np.random.default_rng(3)
    b = batch.batch_size
    noise = {"x_T": rng.normal(size=(b, 8, 3)),
             "h_T": rng.normal(size=(b, 8, 6)),
             "pos": rng.normal(size=(cmp_steps, b, 8, 3)),
             "feat": rng.normal(size=(cmp_steps, b, 8, 6))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    mine: list = []
    on_card, cmp_launches, cmp_corr, cmp_k = chain_on(model, cmp_cfg, batch,
                                                      noise, capture=mine)
    check(cmp_launches == expected_launches(cmp_cfg, cmp_k > 0)
          and cmp_corr == (cmp_steps if cmp_k else 0)
          and (cmp_k > 0) == (k_out > 0),
          f"{name}: card-vs-CPU chain launches {cmp_launches}, "
          f"{cmp_corr} correction passes, k_out {cmp_k}")
    on_cpu = chain_on(model, cmp_cfg, batch, noise, dev="cpu")[0]
    cpu_dev = float((on_card - on_cpu).abs().max())
    check(cpu_dev < CHAIN_TOL, f"{name}: card vs CPU final coords differ "
                               f"by {cpu_dev:.3e} >= {CHAIN_TOL}")
    versus = ""
    if other is not None:
        # the other sampling path with the same weights and noise: final
        # coords in fp32 within the chain tolerance, bf16 printed; the
        # second conv's prot state (what the correction writes) at every
        # step within the conv tolerance
        theirs, faulty, deltas = [], [], []
        alt = chain_on(model, dataclasses.replace(cmp_cfg, **other), batch,
                       noise, capture=theirs)
        alt_dev = float((on_card - alt[0]).abs().max())
        check(alt_dev < CHAIN_TOL and (alt[3] > 0) != (cmp_k > 0)
              and alt[2] == (cmp_steps if alt[3] else 0),
              f"{name}: against {other} (k_out {alt[3]}, {alt[2]} "
              f"correction passes) final coords differ by {alt_dev:.3e} "
              f"(tolerance {CHAIN_TOL})")
        conv_err, conv_over = conv_state_err(mine, theirs)
        check(conv_over <= 0, f"{name}: against {other} the second conv's "
                              f"prot state differs by {conv_err:.3e}, "
                              f"beyond {CONV_TOL}")
        # the check must see a broken correction: the other path with the
        # correction's scatter dropped falls outside the conv tolerance
        with correction_dropped(deltas):
            fault = chain_on(model, dataclasses.replace(cmp_cfg, **other),
                             batch, noise, capture=faulty)
        fault_err, fault_over = conv_state_err(mine, faulty)
        fault_dev = float((on_card - fault[0]).abs().max())
        check(bool(deltas) and fault_over > 0,
              f"{name}: with the correction dropped ({len(deltas)} passes) "
              f"the second conv's prot state differs by {fault_err:.3e}, "
              f"within {CONV_TOL}: the comparison cannot see it")
        bf16 = [chain_on(model, dataclasses.replace(
                    cmp_cfg, compute_dtype="bfloat16", **o), batch, noise)[0]
                for o in ({}, other)]
        versus = (f"; against the path {other} on the card (same weights "
                  f"and noise, k_out {alt[3]}, {alt[2]} correction "
                  f"passes): fp32 final coords max|dx| {alt_dev:.3e} "
                  f"(tolerance {CHAIN_TOL}), the second conv's prot state "
                  f"over {cmp_steps} steps max|d| {conv_err:.3e} "
                  f"(tolerance {CONV_TOL}), bf16 final coords max|dx| "
                  f"{float((bf16[0] - bf16[1]).abs().max()):.3e}; planted "
                  f"fault, that path with the correction dropped: the "
                  f"second conv's prot state max|d| {fault_err:.3e}, final "
                  f"coords max|dx| {fault_dev:.3e}; the correction's "
                  f"largest change to a normalized pp aggregate per pass "
                  f"{max(deltas):.3e} (median "
                  f"{float(np.median(deltas)):.3e})")
    print(f"{name}: B={n_pockets * per_pocket} T={cfg.n_timesteps} "
          f"n_convs={cfg.n_convs} {cfg.compute_dtype} compact tail "
          f"{cfg.compact_prot_tail} k_out {k_out} on {card()}: samples/s "
          f"{' '.join(f'{r:.2f}' for r in rates)}; launches per chain "
          f"{launches}, correction passes {want_corr}; card vs CPU (fp32, "
          f"T={cmp_steps}, B={b}, k_out {cmp_k}) max|dx| {cpu_dev:.3e} "
          f"(tolerance {CHAIN_TOL}){versus}", flush=True)

    if profile:
        profile_chain(name, dev, cfg, model.state_dict(), pockets, n_pharms,
                      atoms)
    return launches


def profile_chain(name: str, dev, cfg, state, pockets, n_pharms,
                  atoms: int) -> None:
    """One chain of `cfg` cut to T <= 100, with the weights `state`, under
    torch.profiler (after a warm-up chain): device busy share and the
    kernels that take the most device time."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    from pharmaforge_tpu_torch.training.sampling import PocketSampler
    steps = min(cfg.n_timesteps, 100)
    model = PharmacophoreDiffusion(
        dataclasses.replace(cfg, n_timesteps=steps), device=dev)
    model.load_state_dict(state)
    sampler = PocketSampler(model, fixed_prot_slots=atoms, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    sampler.sample_stacked(pockets, n_pharms, gen)      # warm-up
    torch.cuda.synchronize()
    profile_run(f"profile {name}: chain of T={steps}",
                lambda: sampler.sample_stacked(pockets, n_pharms, gen), name)


def phase_profile(dev) -> None:
    """`--profile-only DIR`: one dev chain (T=100) and one full-scale chain
    cut to T=100 with and without the compact tail and the correction,
    with the `main`, `fullscale` and `fullwidth` phases' weights and
    pockets, then the `train` phase with its profiled step, each profile's
    full kernel table written to DIR. The script may be copied into an
    earlier checkout of the port to count kernels by name in both trees."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    sizes = np.random.default_rng(0).integers(3, 9, 30)
    for name, cfg, n_pockets in (("main", dev_config(), 8),
                                 ("fullscale", full_config(), 4),
                                 ("fullwidth", fullwidth_config(), 4)):
        model = PharmacophoreDiffusion(
            cfg, device=dev, generator=torch.Generator().manual_seed(0))
        profile_chain(name, dev, cfg, model.state_dict(),
                      synthetic_pockets(n_pockets, 230),
                      [sizes] * n_pockets, 230)
    phase_train(dev, profile=True)


def profile_run(label: str, fn, name: str) -> None:
    """`fn` once under torch.profiler; prints its wall time, the device's
    busy share, each port kernel's time per launch and the 12 kernels that
    take the most device time. With PROFILE_TABLES set, every device
    kernel's count and time go to PROFILE_TABLES/<name>.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def self_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    # device-side events only (kernels, copies): the host ops that launch
    # them report the same time again, and a user annotation on the device
    # (such as the optimizer's step range) spans kernels counted already
    events = [e for e in p.key_averages()
              if e.device_type == DeviceType.CUDA and self_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(self_us(e) for e in events) / 1e6
    top = sorted(events, key=lambda e: -self_us(e))[:12]
    per_kernel = []
    for kname in KERNELS:
        evs = [e for e in events if f"{kname}_kernel" in e.key]
        n = sum(e.count for e in evs)
        per_kernel.append(f"{kname}_kernel {sum(self_us(e) for e in evs) / max(n, 1):.2f} "
                          f"us per launch x{n}")
    print(f"{label} wall {wall:.4f} s under the "
          f"profiler, device busy {busy:.4f} s ({100 * busy / wall:.1f}%) "
          f"in {sum(e.count for e in events)} device kernels and copies; "
          + "; ".join(per_kernel) + "; "
          + "; ".join(f"{e.key[:40]} {self_us(e) / 1e3:.2f} ms x{e.count}"
                      for e in top), flush=True)
    if PROFILE_TABLES is not None:
        table: dict = {}
        for e in events:
            row = table.setdefault(e.key, {"count": 0, "us": 0.0})
            row["count"] += e.count
            row["us"] += self_us(e)
        PROFILE_TABLES.mkdir(parents=True, exist_ok=True)
        (PROFILE_TABLES / f"{name}.json").write_text(json.dumps(
            {"label": label, "wall_s": wall, "busy_s": busy,
             "kernels": table}, indent=1, sort_keys=True))


def phase_main(dev, profile: bool = False, n_pockets: int = 8,
               per_pocket: int = 30, atoms: int = 230, cfg=None) -> dict:
    cfg = cfg or dev_config()
    return phase_sampling("main", dev, cfg, n_pockets, per_pocket, atoms,
                          timed=3, cmp_steps=cfg.n_timesteps,
                          profile=profile)


# --------------------------------------------------------------------- pp

# fp32: the JAX kernel-vs-twin tolerance (tests/test_pp_fused.py:93-96).
# bf16: the kernel rounds to bf16 at the plain version's points, so the two
# differ only where an fp32 sum taken in another order rounds to the other
# bf16 neighbour; rtol 1e-2 is under three bf16 ulps of a sum, a tenth of
# the JAX bf16 bound (rtol 0.08 / atol 0.05)
PP_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
          "bfloat16": dict(rtol=1e-2, atol=1e-3)}


def pp_case(dev, *, dtype: str, n_groups: int = 4, copies: int = 30,
            atoms: int = 230, k: int = 16, nd=None, hj: int = 16,
            masked_row: bool = False, s: int = 128, v: int = 16,
            slots=None, dup: bool = False, table_dtype=None,
            cutoff: float = 3.5, n_gvps: int = 3, layout=None):
    """One K2 call as the main path makes it: the pp edges of synthetic
    pockets at pocket-group level, random node tables in the compute
    dtype (or `table_dtype`), a message chain with seeded weights. `nd`
    picks that many destination atoms per row (the compact-tail call, one
    row per group); `slots` pads the pockets' `atoms` to that many slots
    (the training batch); `dup` makes one source atom occur twice in one
    destination's list and in a list of another tile. `cutoff` is the pp
    radius (3.5 A on the main path; a large one makes every slot of an
    atom with K neighbours an edge); `n_gvps` the message chain's depth.
    `layout` is one of the pocket-copy correction's calls (copies=1 on
    the kernel): "clean", every pp edge of a group its own destination row
    ([G, P*K, 1]); "dirty", the out-edges of each copy's pf-listed atoms
    ([B, m*K_out, 1] over tables of the m = F*pf_k listed rows;
    `correction_case`)."""
    from pharmaforge_tpu_torch.models.conv import message_specs
    from pharmaforge_tpu_torch.models.edges import (EdgeData,
                                                    GroupedEdgeData,
                                                    build_pp_edge)
    from pharmaforge_tpu_torch.models.gvp import GVPChain, reset_parameters_
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    pockets = synthetic_pockets(4, atoms)
    slots = slots or atoms
    prot_x = np.zeros((n_groups, slots, 3), np.float32)
    prot_mask = np.zeros((n_groups, slots), bool)
    for i in range(n_groups):
        px = pockets[i % len(pockets)]["prot_x"]
        prot_x[i, :len(px)] = px
        prot_mask[i, :len(px)] = True
    _, ed = build_pp_edge(torch.from_numpy(prot_x).to(dev),
                          torch.from_numpy(prot_mask).to(dev), cutoff, k)
    gen = torch.Generator(device=dev).manual_seed(n_groups * 100 + k)
    if nd is not None:
        sel = torch.argsort(torch.rand(n_groups, slots, generator=gen,
                                       device=dev), dim=1)[:, :nd]
        ed = EdgeData(*(torch.take_along_dim(
            a, sel.reshape(sel.shape + (1,) * (a.dim() - 2)), dim=1)
            for a in ed))
    if masked_row:
        ed = ed._replace(mask=ed.mask.clone())
        ed.mask[:, 3] = False
    if dup:
        ed = ed._replace(mask=ed.mask.clone(), idx=ed.idx.clone())
        src = ed.idx[:, 5, 0]
        ed.idx[:, 5, 1] = src                    # twice in one list
        ed.idx[:, ed.idx.shape[1] - 3, 0] = src  # and in another tile's
        ed.mask[:, 5, :2] = True
        ed.mask[:, ed.idx.shape[1] - 3, 0] = True
    b = n_groups * copies
    if layout == "clean":
        e = ed.mask.shape[1] * k
        ed = EdgeData(ed.mask.reshape(n_groups, e, 1),
                      ed.idx.reshape(n_groups, e, 1),
                      ed.x_dir.reshape(n_groups, e, 1, 3),
                      ed.d_rbf.reshape(n_groups, e, 1, 16))
    elif layout == "dirty":
        ed, slots = correction_case(dev, ed, prot_x, prot_mask, copies)
        n_groups, copies = b, 1
    edge = GroupedEdgeData(*ed, copies=copies) if copies > 1 else ed
    specs = message_specs(n_gvps, v, s, 16)
    specs[1:] = [dict(sp, hidden_vectors=hj) for sp in specs[1:]]
    chain = reset_parameters_(GVPChain(specs),
                              torch.Generator().manual_seed(7)).to(dev)
    tdt = table_dtype or dt
    pre_s = torch.randn(b, slots, s, generator=gen, device=dev).to(tdt)
    planes = [(0.5 * torch.randn(b, slots, v + 1, generator=gen,
                                 device=dev)).to(tdt) for _ in range(3)]
    kw = dict(scalar_size=s, vector_size=v, rbf_dim=16,
              compute_dtype=dtype, copies=copies)
    return (pre_s, planes, edge, chain), kw


@functools.cache
def fullscale_model(dev):
    """The fullscale phase's model (weights from seed 0), for its probe."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    return PharmacophoreDiffusion(
        full_config(), device=dev, generator=torch.Generator().manual_seed(0))


def correction_case(dev, ed, prot_x, prot_mask, copies: int) -> tuple:
    """The dirty pass of the pocket-copy correction on the group-level pp
    edge `ed` of the pockets (prot_x, prot_mask [G, P]), `copies` rows
    each: pharm centres near the pocket (sizes 3..8 in 8 slots), their
    pf_k=5 nearest atoms from K1's plain version, k_out as
    `PocketSampler` probes it for these pockets, the dirty slots and
    out-edges as the denoiser builds them. Returns (the K=1 edge
    [B, m*K_out, 1], m)."""
    from pharmaforge_tpu_torch.models.conv import dirty_out_edges
    from pharmaforge_tpu_torch.models.dynamics import dirty_slots
    from pharmaforge_tpu_torch.models.edges import (EdgeData,
                                                    build_pp_out_edges)
    from pharmaforge_tpu_torch.ops.knn_select import knn_pf_edges_reference
    from pharmaforge_tpu_torch.training.sampling import probe_pp_k_out
    k_out = probe_pp_k_out(fullscale_model(dev), prot_x, prot_mask)
    rng = np.random.default_rng(12)
    g = prot_x.shape[0]
    b = g * copies
    pharm_x = rng.normal(scale=4.0, size=(b, 8, 3)).astype(np.float32)
    pharm_mask = np.arange(8)[None] < rng.integers(3, 9, b)[:, None]
    tt = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
          (pharm_x, pharm_mask, np.repeat(prot_x, copies, axis=0),
           np.repeat(prot_mask, copies, axis=0))]
    idx, mask, x_dir, _, d_rbf = knn_pf_edges_reference(*tt, 5)
    corr = dirty_slots(EdgeData(mask, idx, x_dir, d_rbf),
                       build_pp_out_edges(ed, k_out), copies)
    edge = dirty_out_edges(ed, copies, corr)[0]
    return edge, corr["slots"].shape[1]


def pp_bound(args, kw) -> tuple:
    """(bytes, operations, edge rows) of one K2 wrapper call, counting what
    this call's data needs: the tables and the weights read once, idx and
    mask of every group-level slot, x_dir and d_rbf of the slots whose
    mask is set (a masked slot's geometry is never used), and the fp32
    outputs written once; two operations per multiply-add of the edge
    terms over the valid group-level slots and of the chain over the valid
    edge rows."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    pre_s, planes, edge, chain = args
    s, v, copies = kw["scalar_size"], kw["vector_size"], kw["copies"]
    r = kw["rbf_dim"]
    b, p, _ = pre_s.shape
    g, nd, k = edge.mask.shape
    h0 = planes[0].shape[-1]
    w = ppm.split_weights(chain, s, r)
    hj = w[7].shape[1]
    n_j = (len(w) - 7) // 7
    valid = int(edge.mask.sum())
    n_bytes = (pre_s.numel() * pre_s.element_size()
               + sum(a.numel() * a.element_size() for a in planes)
               + sum(a.numel() * a.element_size() for a in w)
               + g * nd * k * (edge.idx.element_size()
                               + edge.mask.element_size())
               + valid * (3 * edge.x_dir.element_size()
                          + r * edge.d_rbf.element_size())
               + 4 * b * nd * (s + 3 * v))
    macs = (h0 * s + s * v + 3 * h0 * v
            + n_j * (3 * v * hj + s * s + hj * s + s * v + 3 * hj * v))
    rows = valid * copies
    return n_bytes, 2 * (macs * rows + (r * s + 3 * h0) * valid), rows


def compare(name, got, want, tol) -> float:
    """Max abs error; raises where |got - want| > atol + rtol |want|."""
    worst = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"pp {name}: {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"pp {name}: non-finite")
        err = (g - w).abs()
        over = err - (tol["atol"] + tol["rtol"] * w.abs())
        check(float(over.max()) <= 0, f"pp {name}: max |err| "
                                      f"{float(err.max()):.3e} beyond {tol}")
        worst = max(worst, float(err.max()))
    return worst


# the training batch's pp call: 32 pockets of 230 atoms (164-174 after the
# generator's thinning) in 256 slots (K3's training shape), and in the 192
# slots to which the loader pads the synthetic training set
PPBWD_TRAIN = dict(n_groups=32, copies=1, atoms=230, slots=256)
PP_TRAIN_192 = dict(n_groups=32, copies=1, atoms=230, slots=192)
# K2's cases against its plain version: the main path's calls (sampling,
# compact tail, both training shapes) and the shapes the persistent design
# can get wrong
PP_CASES = {
    "main": {},
    "compact Nd=40 copies=1": dict(n_groups=120, copies=1, nd=40),
    # the pocket-copy correction's calls at the fullscale phase's pockets
    "corr clean K=1 G=4 Nd=3680": dict(n_groups=4, copies=1,
                                       layout="clean"),
    "corr dirty K=1 B=120 P=40 Nd=40*K_out": dict(n_groups=4, copies=30,
                                                  layout="dirty"),
    "train B=32 P=Nd=192": PP_TRAIN_192,
    "train B=32 P=Nd=256": PPBWD_TRAIN,
    "hj=V+1": dict(n_groups=2, copies=3, hj=17),
    "masked destination": dict(n_groups=2, copies=3, masked_row=True),
    "K=1": dict(n_groups=2, copies=3, k=1),
    "odd batch B=3": dict(n_groups=3, copies=1),
    # every slot of an atom is an edge: an item's 1,024 rows span 16 chunks
    # and destinations straddle chunks
    "dense": dict(n_groups=2, copies=3, cutoff=100.0),
    # 4 tiles of 64, 41 and the last item count (140) not a multiple of the
    # grid (132 SMs)
    "Nd=233": dict(n_groups=7, copies=5, slots=240, nd=233),
    # 16 destinations an item, a destination's rows up to a whole chunk
    "K=64": dict(n_groups=2, copies=3, k=64, cutoff=6.0),
    "S=72 V=8 hj=9": dict(n_groups=2, copies=3, s=72, v=8, hj=9),
    # a deeper chain: bf16 weights past the shared memory stage per GVP
    "5 GVPs": dict(n_groups=2, copies=3, n_gvps=5),
}
# the fullscale path's K2 layouts other than the sampling shape, timed in
# bf16
PP_LAYOUTS = ("compact Nd=40 copies=1", "corr clean K=1 G=4 Nd=3680",
              "corr dirty K=1 B=120 P=40 Nd=40*K_out")
# two calls on the same inputs give bit-equal sums (no atomics)
PP_REPEAT = ("main", "train B=32 P=Nd=192", "train B=32 P=Nd=256", "dense",
             "K=64", "corr clean K=1 G=4 Nd=3680",
             "corr dirty K=1 B=120 P=40 Nd=40*K_out")
# K2 bf16 at the sampling shape in its earlier, FMA-only design, timed as
# `ms` is: the wrapper call (the edge terms in plain PyTorch, then the
# kernel) by CUDA-graph replay
PP_EARLIER_MS = 1.2326


def pp_times(dev, dtype: str, extra: dict, calls: int, replays: int):
    """(per-call ms of the wrapper call from CUDA-graph replay, bound in
    ms, bound_by, bytes, operations, edge rows, ms of the kernel alone) of
    K2 on `pp_case(dtype, **extra)`; the bound takes the bf16 tensor-core
    peak for bf16 and the fp32 FMA peak for fp32."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    args, kw = pp_case(dev, dtype=dtype, **extra)
    pre_s, planes, edge, chain = args
    w = ppm.split_weights(chain, kw["scalar_size"], kw["rbf_dim"])
    d = ppm._dims(pre_s, planes, edge, w, **kw)
    with torch.no_grad():
        saved = ppm.kernel_inputs(d, pre_s, planes, edge, w)
    kernel_ms = graph_ms(lambda: ppm._launch_fwd(d, *saved[:6], saved[8]),
                         calls=calls, replays=replays)
    ms = graph_ms(lambda: ppm.fused_message_agg(*args, **kw), calls=calls,
                  replays=replays)
    n_bytes, n_ops, n_rows = pp_bound(args, kw)
    peak = PEAK_BF16_OPS if dtype == "bfloat16" else PEAK_FP32_OPS
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak
    return (ms, max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, n_ops,
            n_rows, kernel_ms)


def rates(ms: float, bound_ms: float, n_bytes: int, n_ops: int,
          kernel_ms: float = 0.0) -> str:
    """Achieved rates and share of the bound of the call, and of the kernel
    alone where `kernel_ms` is given."""
    out = (f"{n_ops / ms / 1e9:.2f} TFLOP/s, {n_bytes / ms / 1e9:.4f} TB/s, "
           f"{100 * bound_ms / ms:.2f}% of the bound")
    if kernel_ms:
        out += (f"; kernel alone {n_ops / kernel_ms / 1e9:.2f} TFLOP/s, "
                f"{n_bytes / kernel_ms / 1e9:.4f} TB/s, "
                f"{100 * bound_ms / kernel_ms:.2f}%")
    return out


def phase_pp(dev) -> dict:
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    errs = {}
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            for name, extra in PP_CASES.items():
                args, kw = pp_case(dev, dtype=dtype, **extra)
                before = ppm.launches
                got = ppm.fused_message_agg(*args, **kw)
                want = ppm.message_agg_reference(*args, **kw)
                torch.cuda.synchronize()
                check(ppm.launches == before + 1,
                      f"pp {name}: the wrapper did not launch the kernel")
                if extra.get("masked_row"):
                    check(not got[0][:, 3].any() and not got[1][:, 3].any(),
                          "pp: a fully masked destination is not zero")
                errs[f"{name} {dtype}"] = compare(f"{name} {dtype}", got,
                                                  want, PP_TOL[dtype])
                if name in PP_REPEAT:
                    again = ppm.fused_message_agg(*args, **kw)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"pp {name} {dtype}: two calls differ")

        args, kw = pp_case(dev, dtype="bfloat16")
        eager_ms = cuda_ms(lambda: ppm.fused_message_agg(*args, **kw),
                           reps=20, warmup=2)
        plain_ms = graph_ms(lambda: ppm.message_agg_reference(*args, **kw),
                            calls=2, replays=3)
        bf = pp_times(dev, "bfloat16", {}, calls=50, replays=10)
        f32 = pp_times(dev, "float32", {}, calls=20, replays=5)
        train = pp_times(dev, "float32", PPBWD_TRAIN, calls=20, replays=5)
        # the fullscale path's other layouts, bf16 as it runs them
        layouts = {}
        for name in PP_LAYOUTS:
            got = pp_times(dev, "bfloat16", PP_CASES[name], calls=50,
                           replays=10)
            largs, _ = pp_case(dev, dtype="bfloat16", **PP_CASES[name])
            layouts[name] = dict(
                ms=got[0], kernel_alone_ms=got[6], bound_ms=got[1],
                bound_by=got[2], edge_rows=got[5],
                slots=largs[2].mask.numel(),
                table_rows=largs[0].shape[1],
                nd=largs[2].mask.shape[1])
    (b, p, s), (g, nd, k) = args[0].shape, args[2].mask.shape
    print(f"pp: {len(errs)} cases within tolerance of the plain version "
          f"(fp32 {PP_TOL['float32']}, bf16 {PP_TOL['bfloat16']}), two calls "
          f"bit-equal in {list(PP_REPEAT)}; max abs err {json.dumps(errs)}; "
          f"sampling shape B={b} (G={g} x {kw['copies']} copies) P={p} "
          f"Nd={nd} K={k} S={s} V={kw['vector_size']} ({bf[5]} of "
          f"{b * nd * k} slots are edges), per call from CUDA-graph replay "
          f"(the wrapper call with its edge terms in plain PyTorch, as the "
          f"earlier design was timed; the kernel alone): bf16 {bf[0]:.4f} ms "
          f"(kernel alone {bf[6]:.4f} ms; earlier design {PP_EARLIER_MS} ms; "
          f"bound {bf[1]:.6f} ms by {bf[2]}: {bf[3]} B at 3.35 TB/s, "
          f"{bf[4]} ops at 989 TFLOP/s bf16; {rates(*bf[:2], *bf[3:5], bf[6])}), "
          f"fp32 {f32[0]:.4f} ms (kernel alone {f32[6]:.4f} ms; "
          f"bound {f32[1]:.6f} ms by {f32[2]}: {f32[3]} B, {f32[4]} ops at "
          f"67 TFLOP/s fp32; {rates(*f32[:2], *f32[3:5], f32[6])}), plain bf16 "
          f"{plain_ms:.4f} ms; training shape B=32 P=Nd=256 fp32 "
          f"({train[5]} edge rows) {train[0]:.4f} ms (kernel alone "
          f"{train[6]:.4f} ms; bound {train[1]:.6f} "
          f"ms by {train[2]}: {train[3]} B, {train[4]} ops at 67 TFLOP/s; "
          f"{rates(*train[:2], *train[3:5], train[6])}); wrapper called eagerly back "
          f"to back {eager_ms:.4f} ms; bf16 layouts of the fullscale path "
          f"(wrapper call; kernel alone; bound; edge rows of slots): "
          + "; ".join(f"{n} [Nd={v['nd']}, table rows {v['table_rows']}] "
                      f"{v['ms']:.4f} ms; {v['kernel_alone_ms']:.4f} ms; "
                      f"{v['bound_ms']:.6f} ms by {v['bound_by']}; "
                      f"{v['edge_rows']} of {v['slots']}"
                      for n, v in layouts.items()), flush=True)
    return {"name": "pp_message", "route": "cuda",
            "source": "pharmaforge_tpu_torch/csrc/pp_message.cu",
            "replaces": "pharmaforge_tpu/ops/pallas/pp_message.py:386",
            "max_abs_err": errs["main bfloat16"], "ms": bf[0],
            "kernel_ms": bf[0], "kernel_alone_ms": bf[6],
            "fp32_ms": f32[0], "fp32_kernel_alone_ms": f32[6],
            "fp32_bound_ms": f32[1], "fp32_bound_by": f32[2],
            "train_fp32_ms": train[0], "train_fp32_kernel_alone_ms": train[6],
            "train_fp32_bound_ms": train[1], "train_fp32_bound_by": train[2],
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bf[1], "bound_by": bf[2], "library_ms": None,
            "layouts_bf16": layouts}


# ----------------------------------------------------------------- ppbwd

# K3 against autograd through the plain version. fp32: the JAX backward
# kernel-vs-twin tolerance (tests/test_pp_fused.py:319-321), per element,
# against the plain version run in fp64. A weight gradient sums ~20 k edge
# rows at the training shape and the fp32 plain version rounds that sum by
# about as much as the tolerance allows (its own deviation from fp64 is
# printed), so an fp32 reference would hold K3 to the reference's rounding
# rather than to the gradient. bf16: against the fp32 plain grads,
# max |a - b| / max(|b|, 1) below the JAX bf16 bound
# (tests/test_pp_fused.py:355-358), set at a 2 x 11 x 4 edge shape. A
# weight gradient sums one bf16-rounded term per edge row, so the error
# grows with the rows: at the training shape (~20 k rows) the plain
# version's own bf16 gradients are 0.32 from its fp32 ones. The bound is
# therefore the larger of 0.25 and 1.5 x the plain version's own bf16
# deviation in the same case.
PPBWD_TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": 0.25}
PPBWD_BF16_FLOOR = 1.5
PPBWD_CASES = {
    "train": PPBWD_TRAIN,
    "copies=3": dict(n_groups=2, copies=3),
    "hj=V+1": dict(n_groups=2, copies=3, hj=17),
    "masked destination": dict(n_groups=2, copies=3, masked_row=True),
    "repeated source": dict(n_groups=2, copies=1, dup=True),
    "K=1": dict(n_groups=2, copies=3, k=1),
    "odd batch B=3": dict(n_groups=3, copies=1),
    # a deeper chain: its stored stages take the 16-row chunks
    "5 GVPs": dict(n_groups=2, copies=3, n_gvps=5),
}


def ppbwd_grads(args, kw, fused: bool, cot):
    """Gradients of <(s_sum, v_sum), cot> w.r.t. pre_s, the three planes
    and every chain parameter, through K2 + K3 (`fused`) or autograd of
    the plain version; the inputs are fp32 leaves."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    pre_s, planes, edge, chain = args
    leaves = [pre_s, *planes, *chain.parameters()]
    for t in leaves:
        t.requires_grad_(True)
    fn = ppm.fused_message_agg if fused else ppm.message_agg_reference
    out = fn(pre_s, planes, edge, chain, **kw)
    return torch.autograd.grad(out, leaves, cot)


def ppbwd_want(args, kw, dtype: str, cot):
    """The plain version's gradients K3 is held to: fp64 for an fp32 K3,
    fp32 for a bf16 one."""
    ref = "float64" if dtype == "float32" else "float32"
    return ppbwd_grads(args, dict(kw, compute_dtype=ref), False, cot)


def fp32_over(got, want) -> float:
    """max over leaves and elements of |a - b| / (atol + rtol |b|) at the
    fp32 tolerance: at most 1 within it."""
    tol = PPBWD_TOL["float32"]
    return max(float(((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs()))
                     .max()) for g, w in zip(got, want))


def bf16_rel(got, want) -> float:
    """max over leaves and elements of |a - b| / max(|b|, 1)."""
    return max(float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
               for g, w in zip(got, want))


def ppbwd_compare(name, got, want, dtype, bound=None) -> float:
    """Per leaf: fp32 |a - b| <= atol + rtol |b|; bf16 max |a - b| /
    max(|b|, 1) < `bound`. Returns the worst error (abs or relative)."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"ppbwd {name}: leaf {i} {tuple(g.shape)} vs {tuple(w.shape)}"
              f" or non-finite")
        err = (g - w).abs()
        if dtype == "float32":
            tol = PPBWD_TOL["float32"]
            over = float((err - tol["atol"] - tol["rtol"] * w.abs()).max())
            check(over <= 0, f"ppbwd {name} fp32: leaf {i} max |err| "
                             f"{float(err.max()):.3e} beyond {tol}")
            worst = max(worst, float(err.max()))
        else:
            rel = float((err / w.abs().clamp(min=1.0)).max())
            check(rel < bound, f"ppbwd {name} bf16: leaf {i} relative "
                               f"error {rel:.3e}, bound {bound:.3e}")
            worst = max(worst, rel)
    return worst


def ppbwd_bound(args, kw) -> tuple:
    """(bytes, operations, edge rows) of one K3 call, counting what this
    call's data needs: the node tables and weights read once in the compute
    dtype, idx and mask of every group-level slot, x_dir and d_rbf of the
    slots whose mask is set, the fp32 cotangents read once, and its outputs
    written once (fp32 node tables, fp64 weight gradients); two operations
    per multiply-add of the chain's recompute and backward over the edge
    rows whose mask is set."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    pre_s, planes, edge, chain = args
    s, v, r = kw["scalar_size"], kw["vector_size"], kw["rbf_dim"]
    copies = kw["copies"]
    b, p, _ = pre_s.shape
    g, nd, k = edge.mask.shape
    h0 = planes[0].shape[-1]
    w = ppm.split_weights(chain, s, r)
    hj = w[7].shape[1]
    n_j = (len(w) - 7) // 7
    elem = ppm.COMPUTE_DTYPES[kw["compute_dtype"]].itemsize
    grads = sum(a.numel() for a in w)
    valid = int(edge.mask.sum())
    n_bytes = (elem * (b * p * (s + 3 * h0) + grads)
               + g * nd * k * (edge.idx.element_size()
                               + edge.mask.element_size())
               + valid * (3 * edge.x_dir.element_size()
                          + r * edge.d_rbf.element_size())
               + 4 * b * nd * (s + 3 * v)
               + 4 * b * p * (s + 3 * h0) + 8 * grads)
    fwd = (h0 * s + s * v + 3 * h0 * v
           + n_j * (3 * v * hj + s * s + hj * s + s * v + 3 * hj * v))
    bwd = (2 * s * v + 6 * h0 * v + r * s + 2 * h0 * s + 3 * h0
           + n_j * (2 * s * v + 12 * v * hj + 2 * s * s + 2 * hj * s))
    rows = valid * copies
    return n_bytes, 2 * (fwd + bwd) * rows, rows


def phase_ppbwd(dev, cases=None) -> dict:
    """K3 against autograd through the plain version over `cases`; a fully
    masked destination's cotangent reaches no node; device times at the
    training shape."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    cases = PPBWD_CASES if cases is None else cases
    errs = {}
    for dtype in ("float32", "bfloat16"):
        for name, extra in cases.items():
            args, kw = pp_case(dev, dtype=dtype, table_dtype=torch.float32,
                               **extra)
            gen = torch.Generator(device=dev).manual_seed(5)
            b, nd = args[0].shape[0], args[2].mask.shape[1]
            cot = (torch.randn(b, nd, kw["scalar_size"], generator=gen,
                               device=dev),
                   torch.randn(b, nd, kw["vector_size"], 3, generator=gen,
                               device=dev))
            before = ppm.bwd_launches
            got = ppbwd_grads(args, kw, True, cot)
            torch.cuda.synchronize()
            check(ppm.bwd_launches == before + 1,
                  f"ppbwd {name}: the wrapper did not launch K3")
            want = ppbwd_want(args, kw, dtype, cot)
            bound = None
            if dtype == "float32":
                # the fp32 plain version's own distance from fp64, in units
                # of the tolerance (information: not checked)
                errs[f"{name} plain fp32 / tol"] = fp32_over(
                    ppbwd_grads(args, kw, False, cot), want)
                errs[f"{name} K3 fp32 / tol"] = fp32_over(got, want)
                if extra is PPBWD_TRAIN:
                    # the weight gradients are sums in a fixed order
                    again = ppbwd_grads(args, kw, True, cot)
                    check(all(torch.equal(a, b)
                              for a, b in zip(got[4:], again[4:])),
                          "ppbwd train fp32: two calls gave different "
                          "weight gradients")
            else:
                floor = bf16_rel(ppbwd_grads(args, kw, False, cot), want)
                bound = max(PPBWD_TOL["bfloat16"], PPBWD_BF16_FLOOR * floor)
                errs[f"{name} plain bf16"] = floor
            errs[f"{name} {dtype}"] = ppbwd_compare(name, got, want, dtype,
                                                    bound)
            if extra.get("masked_row"):
                # a cotangent on the fully masked destination alone
                only = tuple(torch.zeros_like(c) for c in cot)
                only[0][:, 3], only[1][:, 3] = cot[0][:, 3], cot[1][:, 3]
                zero = ppbwd_grads(args, kw, True, only)
                check(all(not z.any() for z in zero),
                      "ppbwd: a fully masked destination reached a node or "
                      "weight gradient")

    # device times at the training shape, both compute dtypes
    times = {}
    for dtype in ("float32", "bfloat16"):
        args, kw = pp_case(dev, dtype=dtype, table_dtype=torch.float32,
                           **PPBWD_TRAIN)
        pre_s, planes, edge, chain = args
        weights = ppm.split_weights(chain, kw["scalar_size"], kw["rbf_dim"])
        d = ppm._dims(pre_s, planes, edge, weights, **kw)
        with torch.no_grad():
            saved = ppm.kernel_inputs(d, pre_s, planes, edge, weights)
        gen = torch.Generator(device=dev).manual_seed(6)
        ds = torch.randn(d.b, d.nd, d.s, generator=gen, device=dev)
        dv = torch.randn(d.b, d.nd, d.v, 3, generator=gen, device=dev)
        times[dtype] = graph_ms(lambda: ppm._launch_bwd(d, saved, ds, dv),
                                calls=10, replays=3)
        if dtype == "float32":
            leaves = [pre_s, *planes, *chain.parameters()]
            for t in leaves:
                t.requires_grad_(True)
            times["fwd_bwd"] = cuda_ms(lambda: torch.autograd.grad(
                ppm.fused_message_agg(pre_s, planes, edge, chain, **kw),
                leaves, (ds, dv)), reps=10, warmup=2)
            out = ppm.message_agg_reference(pre_s, planes, edge, chain, **kw)
            times["plain"] = cuda_ms(lambda: torch.autograd.grad(
                out, leaves, (ds, dv), retain_graph=True), reps=5, warmup=1)
            n_bytes, n_ops, n_rows = ppbwd_bound(args, kw)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_OPS
    print(f"ppbwd: {2 * len(cases)} cases within tolerance of autograd through "
          f"the plain version (fp32 {PPBWD_TOL['float32']} against the plain "
          f"version in fp64, bf16 relative "
          f"< max({PPBWD_TOL['bfloat16']}, {PPBWD_BF16_FLOOR} x the plain "
          f"version's own bf16 deviation) against fp32); errors "
          f"{json.dumps(errs)}; a fully masked destination reaches no "
          f"gradient; training shape B={d.b} P={d.p} Nd={d.nd} K={d.k} "
          f"S={d.s} V={d.v} ({n_rows} of {d.b * d.nd * d.k} slots are "
          f"edges): K3 per call from CUDA-graph replay fp32 "
          f"{times['float32']:.4f} ms, bf16 {times['bfloat16']:.4f} ms; "
          f"K2 + K3 forward and backward (eager, fp32) "
          f"{times['fwd_bwd']:.4f} ms; plain version's backward (eager, "
          f"fp32) {times['plain']:.4f} ms; bound "
          f"{max(t_bytes, t_ops) * 1e3:.6f} ms ({n_bytes} B at 3.35 TB/s, "
          f"{n_ops} ops at 67 TFLOP/s fp32); library call: none",
          flush=True)
    return {"name": "pp_message_bwd", "route": "cuda",
            "source": "pharmaforge_tpu_torch/csrc/pp_message_bwd.cu",
            "replaces": "pharmaforge_tpu/ops/pallas/pp_message.py:714",
            "max_abs_err": errs.get("train float32"), "ms": times["float32"],
            "bf16_ms": times["bfloat16"], "fwd_bwd_ms": times["fwd_bwd"],
            "plain_ms": times["plain"],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


# -------------------------------------------------------------- fullscale

def phase_fullscale(dev, profile: bool = False) -> dict:
    return phase_sampling("fullscale", dev, full_config(), n_pockets=4,
                          per_pocket=30, atoms=230, timed=2, cmp_steps=20,
                          profile=profile)


def phase_fullwidth(dev, profile: bool = False) -> dict:
    return phase_sampling("fullwidth", dev, fullwidth_config(),
                          n_pockets=4, per_pocket=30, atoms=230, timed=1,
                          cmp_steps=20, profile=profile,
                          other=dict(compact_prot_tail=True))


# ------------------------------------------------------------------ train

PER_STEP = {"knn_select": 1, "pp_message": 2, "pp_message_bwd": 2}


def train_config(data_dir: str, max_epochs: int = 2, dropout: float = 0.1,
                 batch_size: int = 32) -> dict:
    """The reference-size model as `bench.py`'s full-scale training bench
    builds it (bench.py:456-465): n_convs=4, 128 scalars, 16 vectors,
    3/2/4 message/update/noise GVPs, pf_k=5, pp_k_max=16, dropout 0.1,
    endpoint parameterization, fp32, T=1000; batch 32, validation on
    split 2, one sampling evaluation in two epochs (8 pockets x 2)."""
    return {
        "training": {"batch_size": batch_size, "validation_splits": [2],
                     "trainer_args": {"max_epochs": max_epochs},
                     "evaluation": {"pharms_per_pocket": 2, "n_pockets": 8,
                                    "sample_interval": 1.0,
                                    "val_loss_interval": 1.0}},
        "lr_scheduler": {"base_lr": 1e-3, "weight_decay": 1e-12,
                         "reducelronplateau": {"mode": "min", "factor": 0.1,
                                               "patience": 20,
                                               "min_lr": 1e-5}},
        "checkpointing": {"save_last": True, "save_top_k": 3},
        "wandb": {"mode": "disabled"},
        "dataset": {"raw_data_dir": "", "processed_data_dir": data_dir,
                    "prot_elements": ["C", "N", "O", "S", "P", "F", "Cl",
                                      "Br", "I", "B", "D"],
                    "ph_type_map": ["Aromatic", "HydrogenDonor",
                                    "HydrogenAcceptor", "PositiveIon",
                                    "NegativeIon", "Hydrophobic"],
                    "subsample_pharms": True, "subsample_min": 4,
                    "subsample_max": 8},
        "graph": {"graph_cutoffs": {"pp": 3.5, "pf": 8, "fp": 8, "ff": 9},
                  "pp_k_max": 16},
        "diffusion": {"n_timesteps": 1000, "precision": 1e-4,
                      "endpoint_param_feat": True,
                      "endpoint_param_coord": True, "remove_com": True},
        "dynamics": {"vector_size": 16, "n_convs": 4, "n_hidden_scalars": 128,
                     "message_norm": "mean", "dropout": dropout, "ff_k": 0,
                     "pf_k": 5, "n_message_gvps": 3, "n_update_gvps": 2,
                     "n_noise_gvps": 4, "compute_dtype": "float32"},
    }


def count_steps(trainer, per_step: list) -> None:
    """Wrap `trainer.train_step` so each optimizer step's kernel launches
    (the counts just after it less those just before it) go to
    `per_step`."""
    step = trainer.train_step

    def counted(batch):
        before = read_launches()
        out = step(batch)
        after = read_launches()
        per_step.append({k: after[k] - before[k] for k in after})
        return out

    trainer.train_step = counted


def grads_close(got: dict, want: dict) -> float:
    """Per leaf max |a - b| <= 2e-4 max |b| + 2e-5; returns the worst
    ratio of the error to its bound."""
    worst = 0.0
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        bound = 2e-4 * float(w.abs().max()) + 2e-5
        check(err <= bound, f"train: card vs CPU gradient {k} max |a - b| "
                            f"{err:.3e} > {bound:.3e}")
        worst = max(worst, err / bound)
    return worst


def card_vs_cpu_step(model, batch, rows: int = 8) -> str:
    """One fp32 loss + backward at dropout 0 from `model`'s weights with
    injected noise, on the card and on the CPU, over the batch's first
    `rows` rows: losses within rtol 1e-5, gradients per leaf."""
    from pharmaforge_tpu_torch.data.batch import PharmComplexBatch
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    cfg = dataclasses.replace(model.config, dropout=0.0)
    sub = PharmComplexBatch(**{f.name: getattr(batch, f.name)[:rows]
                               for f in dataclasses.fields(PharmComplexBatch)})
    rng = np.random.default_rng(4)
    b, f = sub.pharm_mask.shape
    noise = {"t_int": rng.integers(0, cfg.n_timesteps, b),
             "eps_x": rng.normal(size=(b, f, 3)).astype(np.float32),
             "eps_h": rng.normal(size=(b, f, cfg.pharm_nf)).astype(np.float32)}
    out = {}
    for name in ("card", "cpu"):
        m = PharmacophoreDiffusion(
            cfg, device=model.device if name == "card" else "cpu")
        m.load_state_dict(model.state_dict())
        reset_launches()
        total, _ = m.loss(sub, train=True, noise=noise)
        total.backward()
        launched = read_launches()
        out[name] = (total.item(), {k: p.grad.detach().cpu()
                                    for k, p in m.named_parameters()},
                     launched)
    (loss_g, g_g, n_g), (loss_c, g_c, _) = out["card"], out["cpu"]
    check(n_g == PER_STEP, f"train: card step launches {n_g}")
    check(abs(loss_g - loss_c) <= 1e-5 * abs(loss_c),
          f"train: card loss {loss_g!r} vs CPU {loss_c!r}")
    worst = grads_close(g_g, g_c)
    return (f"card vs CPU (fp32, dropout 0, {b} rows, injected noise): loss "
            f"{loss_g!r} vs {loss_c!r} (rel {abs(loss_g - loss_c) / abs(loss_c):.2e}"
            f", tolerance 1e-5), worst gradient leaf at {worst:.3f} of its "
            f"bound 2e-4 max|b| + 2e-5")


def phase_train(dev, profile: bool = False, config_fn=train_config,
                samples_per_split: int = 64, n_prot_range=(200, 230)) -> dict:
    """`Trainer.fit` at full scale on the card: 2 epochs, then a third
    resumed from 'last'. Every optimizer step launches K1 once and K2 and
    K3 twice; losses are finite; the checkpoint restores bit-equal weights;
    train steps/s over the timed steps (the first step of each run is the
    warm-up; validation and sampling fall between steps and are not
    timed). Returns the launch counts of the 2-epoch fit."""
    import tempfile
    from pharmaforge_tpu_torch.config.load_from_config import (
        data_module_from_config, model_from_config)
    from pharmaforge_tpu_torch.data.synthetic import (
        make_synthetic_processed_dataset)
    from pharmaforge_tpu_torch.training.checkpoints import RunCheckpointer
    from pharmaforge_tpu_torch.training.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = make_synthetic_processed_dataset(
            f"{tmp}/data", n_splits=3, samples_per_split=samples_per_split,
            n_prot_range=n_prot_range, seed=11)
        gen_s = time.perf_counter() - t0
        config = config_fn(str(data))
        dm = data_module_from_config(config)
        model = model_from_config(config, device=dev)
        trainer = Trainer(config, f"{tmp}/run", device=dev)
        per_step: list = []
        count_steps(trainer, per_step)
        reset_launches()
        t0 = time.perf_counter()
        trainer.fit(model, dm)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = read_launches()
        check(len(per_step) == trainer.global_step > 0,
              f"train: {len(per_step)} counted steps, global step "
              f"{trainer.global_step}")
        check(all(c == PER_STEP for c in per_step),
              f"train: launches per optimizer step {per_step}, expected "
              f"{PER_STEP}")
        slots = {int(dm.train_dataset.prot_size(i))
                 for i in range(len(dm.train_dataset))}
        records = [json.loads(ln) for ln in
                   Path(f"{tmp}/run/metrics.jsonl").read_text().splitlines()]
        losses = [r[k] for r in records for k in r if "loss" in k]
        check(bool(losses) and bool(np.isfinite(losses).all()),
              "train: non-finite or missing losses")
        validity = [r["validity"] for r in records if "validity" in r]
        check(len(validity) == 1, f"train: {len(validity)} sampling "
                                  f"evaluations in 2 epochs, expected 1")
        state, meta = RunCheckpointer(f"{tmp}/run").restore("last")
        check(all(torch.equal(state["model"][k], v.cpu())
                  for k, v in model.state_dict().items()),
              "train: the checkpoint does not restore bit-equal weights")
        cmp = card_vs_cpu_step(model, next(iter(dm.train_dataloader(0))))

        config3 = config_fn(str(data), max_epochs=3)
        resumed = Trainer(config3, f"{tmp}/run", device=dev)
        count_steps(resumed, per_step)
        resumed.fit(model_from_config(config3, device=dev, seed=1),
                    data_module_from_config(config3), resume_from="last")
        check(resumed.epoch == 3 and resumed.global_step
              == 3 * trainer.global_step // 2,
              f"train: resumed to epoch {resumed.epoch}, step "
              f"{resumed.global_step}")
        check(all(c == PER_STEP for c in per_step),
              f"train: launches per optimizer step {per_step}")
        timed = trainer.step_seconds[1:] + resumed.step_seconds[1:]
        rates = sorted(1.0 / s for s in timed)
        if profile:
            batch = next(iter(dm.train_dataloader(0)))
            resumed.train_step(batch)                       # warm-up
            torch.cuda.synchronize()
            profile_run("profile train: one optimizer step (B=32)",
                        lambda: resumed.train_step(batch), "train")
    losses_train = [r["train total loss"] for r in records
                    if "train total loss" in r]
    print(f"train: Trainer.fit on {card()}: {trainer.global_step} steps in "
          f"2 epochs + {resumed.global_step - trainer.global_step} resumed "
          f"(epoch 3 from 'last'), batch {trainer.batch_size}, pocket slots "
          f"{sorted({max(64, -(-n // 64) * 64) for n in slots})} (atoms "
          f"{min(slots)}-{max(slots)}); train steps/s over "
          f"{len(timed)} timed steps median {float(np.median(rates)):.3f}, "
          f"min {rates[0]:.3f}, max {rates[-1]:.3f}; fit wall {fit_s:.1f} s "
          f"(validation and one sampling evaluation included; validity "
          f"{validity[0]:.3f}); train total loss {losses_train[0]:.4f} -> "
          f"{losses_train[-1]:.4f}, val {meta['monitored']:.4f}; launches "
          f"per optimizer step {PER_STEP} in all {len(per_step)} steps; "
          f"the 2-epoch fit launched {fit_launches}; checkpoint round trip "
          f"bit-equal; {cmp}; dataset generated in {gen_s:.1f} s",
          flush=True)
    return fit_launches


def main() -> int:
    global PROFILE_TABLES
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    phase_build()
    if "--profile-only" in sys.argv[1:]:
        PROFILE_TABLES = Path(sys.argv[sys.argv.index("--profile-only") + 1])
        phase_profile(dev)
        return 0
    knn = phase_knn(dev)
    phase_golden(dev)
    dev_launches = phase_main(dev, profile)
    pp = phase_pp(dev)
    full_launches = phase_fullscale(dev, profile)
    width_launches = phase_fullwidth(dev, profile)
    ppbwd = phase_ppbwd(dev)
    train_launches = phase_train(dev, profile)
    kernels = [knn, pp, ppbwd]
    for kern in kernels:
        # `launches`: this slice's main path, the 2-epoch training run
        kern["launches"] = train_launches[kern["name"]]
        kern["launches_fullscale_chain"] = full_launches[kern["name"]]
        kern["launches_fullwidth_chain_t100"] = width_launches[kern["name"]]
        kern["launches_dev_chain"] = dev_launches[kern["name"]]
        check(kern["launches"] > 0, f"{kern['name']}: not launched by the "
                                    f"training run")
    print(card())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
