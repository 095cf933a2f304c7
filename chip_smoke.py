#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`pharmaforge_tpu_torch`).

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # also traces chains (dev, full scale
                                     # with and without the correction), a
                                     # train step and a captured train call
                                     # with torch.profiler
    python3 chip_smoke.py --profile-only DIR  # only the build, those
                                     # traces and the train phase; each
                                     # kernel table by name into DIR

Phases, one line each, then a `wall:` line with the phase's seconds; any
failure raises and the script exits non-zero. They run in the order build,
preprocess, knn, golden, graphs, main, pp, gvpchain, fullscale, fullwidth,
tables, ppbwd, trainstep, evalstep, train, dist, cli, bench.

Every sampling chain on the card runs as CUDA graph replays
(`models/diffusion.py::ChainGraphs`: a warm-up step, U =
`sample_scan_unroll` steps captured in one graph and the T mod U left in
another, the graphs kept for the next chain of the same signature). The
kernels' wrappers count a launch where it is made or captured; a chain's
launches are its graphs' replayed launches (`read_replayed`: each graph's
captured launches x its replays), which the phases hold to exactly
`expected_launches`, with the replays counted (`chain_replays`) and, for a
call on kept graphs, nothing launched outside them. Checks that copy a
step's state to the host drive the eager step loop (`eager_chain`).
Every optimizer step on the card runs inside a replayed CUDA graph too
(`training/train_state.py::TrainGraphs`, `steps_per_call` steps a
replay): a train call's launches are its graph's captured launches x its
replay (`read_train_replayed`), and the wrappers count only the warm-up
step and the capture of a call that builds its graph (`check_calls`). So
does every validation batch (`training/train_state.py::EvalGraphs`, one
graph per batch shape, `read_eval_replayed`, `check_vals`).

1. build     -- compile every CUDA kernel of the sampling and training
                paths from `pharmaforge_tpu_torch/csrc` (nvcc, sm_90a; one
                nvcc per source, all started together);
   preprocess -- before anything initialises CUDA (the preprocessing
                CLI's pool forks): a CrossDocked-layout raw tree of 3 x 96
                seeded rigid copies of tests/fixtures/realchem (plus a
                label-0 row and a missing pair a split) through
                `python -m pharmaforge_tpu_torch.cli.process_crossdocked`
                (`main(argv)`, 4 workers, the JAX tests' stand-ins for
                pharmit, RDKit and the SMARTS sites): its printed counts,
                6 centres, 54 pocket atoms and 8 sites an example, the
                first example's coordinates under its motion; the C++
                packer built and taken, its median times against numpy's;
                the train CLI fitting the train cell's model for one epoch
                on the processed set (exactly 1 K1, 2 K2 and 2 K3 launches
                a step; the first K1, K2 and K3 calls against their plain
                versions); the test CLI on that run (1 pocket x 4, T=100)
                with the JAX package's skip line for pocket.pdb; the hinge
                loss on the card against the CPU;
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
                on the card within 2e-3, each in T graph replays, the knn
                chain through K1 exactly T times;
   graphs    -- the captured chain against the eager step loop with the
                same injected noise, within 2e-3: the dev model in fp32
                (T=100, B=240), the full-scale model in bf16 (T=1000,
                B=120, the correction on) and that model with the step
                tables; U in {4, 7} against U=1 (7 leaves a tail graph);
                the planted fault `step_index_frozen` at least 10 x the
                tolerance away; exact replayed counts and replays of every
                call; capture time, graph pool bytes and the per-call
                overhead of kept graphs; samples/s in alternating turns:
                eager against captured (dev; full scale with the step
                tables captured too), then the compact tail against full
                width, captured (`phase_graphs`);
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
   gvpchain -- the GVP-chain kernel (K4) against the plain chain in the
                chain's dtype at the full-screen step's shapes (960 to
                30,720 rows, `GVP_CHAIN_CASES`), the radius-screen
                message chains (122,880 dense and 61,440 slot rows,
                bf16) and the other dtype of
                each chain, within `GVP_CHAIN_TOL`; two launches
                bit-equal, a captured launch bit-equal to eager; the step's
                shapes and the radius message chains timed
                beside K4's bound and the plain chain (no library call
                computes a GVP chain); a full-screen chain with K4 against
                the plain chains within the benchmark's `x_gap_median` and
                `h_gap` limits, 21 K4 launches a step replayed;
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
   trainstep -- the train step as one device program at the bench's
                full-scale train workload (the train cell's model, B=32
                pockets of 230 atoms in 256 slots, fp32, dropout 0.1, K=8
                steps a call): a captured call against K eager steps from
                the same weights, Adam state and generator (losses rtol
                1e-5, weight leaves 2e-4 max|b| + 2e-5, generators equal),
                building its graph and on the kept graph; again at K=1 and
                at accumulate 3 from phases 0 and 2; the planted faults
                `frozen_lr` and `stale_batches` at least 10 x the tolerance
                away; exactly 1 K1, 2 K2, 2 K3 a step replayed; train
                steps/s eager against captured in alternating turns,
                capture ms and graph pool bytes (`phase_trainstep`);
   evalstep  -- the validation step as one device program: the same model
                and shape and a second bucket (180 atoms in 192 slots),
                each batch captured against eager from equal weights and
                generator states (metrics within rtol 1e-5, generators
                equal), building each graph, on kept graphs and after a
                captured train call; exactly 1 K1, 2 K2, 0 K3 a batch
                replayed; the planted faults `stale_val_batches` and
                `frozen_weights` at least 10 x the tolerance away;
                validation batches/s eager against captured in turns,
                capture ms and pool bytes (`phase_evalstep`);
8. train     -- `Trainer.fit` at full scale, 8 steps a call: the
                reference-size model in fp32 with dropout 0.1
                (bench.py:456-465) on a synthetic 3 x 144-pocket dataset
                (200-230 atoms, seed 11), batch 32: two epochs without a
                stop (one sampling evaluation), then one epoch and the
                second resumed from 'last': every call a graph replay with
                exactly 1 K1, 2 K2 and 2 K3 a step, calls of 8 and
                leftovers, finite losses, a bit-equal checkpoint round
                trip, the resumed epoch against the run without a stop,
                train steps/s; every validation batch a graph replay with
                exactly 1 K1 and 2 K2, and the first epoch again with
                validation eager: validation's share of each fit's wall;
                and one fp32 step at dropout 0 on the card
                and on the CPU from the same weights and injected noise
                (loss within rtol 1e-5, gradients per leaf within 2e-4
                max|b| + 2e-5);
9. cli       -- the port's three CLIs through `main(argv)` in this process,
                the reference-size model (`cli_config`): the train CLI
                writes its synthetic set (3 x 32 pockets) and fits one
                epoch, then resumes for a second (exactly 1 K1, 2 K2 and 2
                K3 a step as each train call's graph replays them, the
                step count going on,
                config.yaml read back as the merged config); the run is
                exported as a reference `.ckpt` whose weights read back
                bit-equal; the test CLI samples 4 validation pockets x 8 in
                one stacked T=1000 fp32 chain and the generate CLI the
                realchem aspirin pocket x 30 in one bf16 T=1000 chain from
                that `.ckpt`, each with its artifacts, finite centres of
                3-8 typed by the 6-type map, and exactly the K1 and K2
                launches of `expected_launches` for the probed k_out; the
                wall of each CLI with the card's name and power limit;
                and the generate CLI again with `--latency_mode on` (the
                step tables), checked alike, its chain time beside;
10. tables   -- the step tables (`precompute_step_tables`) on the
                full-scale sampling model, 4 pockets x 30 (B=120): the
                build at T=1000 (bytes, chunks, peak device memory); the
                first denoiser call of a fp32 T=1000 chain with tables
                against the per-step chain at the conv tolerance (its
                outputs and the second conv's state), with the tables
                misordered (`tables_misordered`, a planted fault) outside
                it, and built from the pocket groups rolled by one
                (`tables_rolled`) 10 x outside it, each excess in units of
                the tolerance; a fp32 T=100 chain with tables within
                2e-3 of the per-step one; a bf16 T=1000 chain of each path
                (samples/s of both, exactly 1,000 K1, 3,000 K2 and 1,000
                correction passes, the final-coordinate deviation
                printed); device kernels per step of each path;
11. dist     -- data parallelism over torch.distributed: one epoch of the
                train phase's model on 3 x 24 synthetic pockets, then one
                `sample_stacked` (the full-scale model in fp32 at T=50, 2
                pockets x 8), without a process group, as one NCCL rank
                and as two gloo ranks sharing the card: the train steps
                captured without a group and on the NCCL rank (the
                all-reduce inside the graph), eager on the gloo ranks
                (printed); every rank exactly 1 K1, 2 K2 and 2 K3 a step,
                weights
                within the fp32 train-step tolerance of the no-group run's
                (NCCL bit-equality printed), rank 0 alone writing, the
                samples within 2e-3, each rank's chain in its own graphs'
                T replays;
12. bench    -- `python -m pharmaforge_tpu_torch.bench --repeats 2` in
                this process (`bench.main`): its JSON line printed, every
                key of BENCH_KEYS, rates positive, MFU at most 1, the train
                workloads' steps captured (train graph replays counted).

Then the card's name and power limit, the `kernels` JSON line, and the
final `{"ok": true, ...}` line. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gzip
import hashlib
import json
import pickle
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
    built = KERNELS + ("gvp_chain",)
    with ThreadPoolExecutor(len(built) + 1) as pool:
        floor = pool.submit(build_floor)
        libs = list(pool.map(_build.build, built))
        floor.result()
    secs = time.perf_counter() - t0
    for name, lib in zip(built, libs):
        ptxas = [ln.strip() for ln in
                 lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
        print(f"build: {name}.cu -> {lib.name}; {' | '.join(ptxas)}",
              flush=True)
    print(f"build: {len(built)} kernels and the empty kernel in "
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
    before = read_launches()["knn_select"]
    got = ks.knn_select(*args, k)
    want = ks.knn_select_reference(*args, k)
    torch.cuda.synchronize()
    made = read_launches()["knn_select"] - before
    check(made == 1, f"knn {name}: knn_select launched {made} kernels")
    for label, g, w in zip(("idx", "dist", "xg"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"knn {name}: {label} {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        check(torch.equal(g, w), f"knn {name}: {label} differs from "
                                 f"the plain version")
    got = ks.knn_pf_edges(*args, k)
    want = ks.knn_pf_edges_reference(*args, k)
    torch.cuda.synchronize()
    check(read_launches()["knn_select"] == before + 2,
          f"knn {name}: knn_pf_edges did not launch the kernel once")
    return knn_pf_compare(name, got, want)


def knn_pf_compare(name: str, got, want) -> float:
    """`knn_pf_edges`' outputs against its plain version's: idx and mask
    bit-equal, the geometry within KNN_GEOM_ATOL. Returns the geometry's
    max abs error."""
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
    from pharmaforge_tpu_torch.utils import trace
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

    before = read_launches()["knn_select"]
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
    # timing launches are not the main path's: taken back
    trace.count("knn_select.launches",
                before - read_launches()["knn_select"])
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
        reset_launches()
        out = model.sample_given_receptor(
            batch, init_pharm_com=np.broadcast_to(data["init_com"], (b, 3)),
            visualize_trajectory=True, noise=noise)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        launched = read_replayed()["knn_select"]
        want = cfg.n_timesteps if cfg.pf_k else 0
        check(launched == want and replay_counts()[0]
              == chain_replays(cfg),
              f"golden {name}: {launched} knn_select launches in "
              f"{replay_counts()[0]} graph replays, expected {want} in "
              f"{chain_replays(cfg)}")
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
                      f"{launched} knn launches in "
                      f"{replay_counts()[0]} graph replays")
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


def reset_launches() -> None:
    """Every counter of the port's registry (`utils/trace.py`) to 0: the
    kernels' launches, the correction passes and the chain, train and
    validation graphs' captures and replays."""
    from pharmaforge_tpu_torch.utils import trace
    trace.reset()


def read_launches() -> dict:
    """The wrappers' counts: launches made eagerly, and launches captured
    into a graph (counted once, where captured)."""
    from pharmaforge_tpu_torch.utils import graphs
    counts = graphs.kernel_counts()
    return {name: counts[name] for name in KERNELS}


def replayed(kind: str) -> dict:
    """The launches that `kind` ("chain", "train", "eval") graphs'
    replays ran: each graph's captured launches x its replays, per
    kernel."""
    from pharmaforge_tpu_torch.utils import trace
    counts = trace.counters()
    return {name: counts[f"{kind}.replayed.{name}"] for name in KERNELS}


def read_replayed() -> dict:
    """The launches that chain graphs' replays ran, per kernel."""
    return replayed("chain")


def read_train_replayed() -> dict:
    """The launches that train graphs' replays ran, per kernel."""
    return replayed("train")


def replay_counts() -> tuple:
    """(chain graph replays, correction passes those replays ran)."""
    from pharmaforge_tpu_torch.utils import trace
    counts = trace.counters()
    return counts["chain.replays"], counts["chain.replayed.corrections"]


def replay_count(kind: str) -> int:
    """The replays of `kind` ("chain", "train", "eval") graphs."""
    from pharmaforge_tpu_torch.utils import trace
    return trace.counters()[f"{kind}.replays"]


def capture_count(kind: str) -> int:
    """The `kind` ("chain", "train", "eval") graph runners built."""
    from pharmaforge_tpu_torch.utils import trace
    return trace.counters()[f"{kind}.captures"]


def chain_replays(cfg) -> int:
    """Graph replays of one chain of `cfg`: T // U, and one more for the
    T mod U steps left (U = max(1, sample_scan_unroll), at most T)."""
    u = min(max(1, cfg.sample_scan_unroll), cfg.n_timesteps)
    return cfg.n_timesteps // u + int(cfg.n_timesteps % u > 0)


def expected_launches(cfg, corrected: bool = False) -> dict:
    """One chain of `cfg`: K1 once per denoiser call (knn pf), K2 once per
    middle conv (convs 1 .. n-2) per call, and once more where the second
    conv runs the pocket-copy correction (a clean and a dirty pass). On
    the card a chain's launches are its graphs' (`read_replayed`)."""
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


def eager_chain(model, batch, **kw) -> dict:
    """`model`'s chain driven step by step through `chain_step` in a
    Python loop (`sample_given_receptor`'s keywords): the chain without
    graphs, which no entry point runs on the card. Forward hooks that copy
    to the host see every step here; in a captured chain they would run
    once, at capture."""
    chain = model.chain_setup(batch, **kw)
    for _ in range(chain.n_steps):
        model.chain_step(chain)
    return model.chain_result(chain)


def chain_on(model, cfg, batch, noise, dev=None,
             capture: list | None = None, eager: bool = False) -> tuple:
    """The injected-noise chain of `model`'s weights under `cfg` for the
    one-pocket `batch`, on `dev` (the model's device by default), grouped
    with the probed `pp_k_out`: (final pharm_x, the chain's launch counts
    and correction passes, k_out); on the card the chain runs captured,
    and its counts are its graphs' replayed launches. `capture` collects
    the second conv's prot output (scalars, vectors) of every step (the
    state the pocket-copy correction writes) from the eager step loop of
    the same chain, whose final coordinates must agree with the captured
    chain's within the chain tolerance. `eager` runs the eager step loop
    alone (for a planted fault whose code reads values on the host, which
    no capture allows); its counts are then the wrappers'."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    from pharmaforge_tpu_torch.training.sampling import probe_pp_k_out
    m = PharmacophoreDiffusion(cfg, device=dev or model.device)
    m.load_state_dict(model.state_dict())
    k_out = probe_pp_k_out(m, batch.prot_x[:1], batch.prot_mask[:1])
    kw = dict(noise=noise, pocket_group_size=batch.batch_size,
              pp_k_out=k_out)
    reset_launches()
    out = launched = corr = None
    if not eager:
        out = m.sample_given_receptor(batch, **kw)["pharm_x"].cpu()
        replays, corr = replay_counts()
        launched = read_replayed() if replays else read_launches()
    if capture is not None or eager:
        handle = m.dynamics.noise_predictor.conv_layers[1] \
            .register_forward_hook(lambda mod, args, o: capture.append(
                (o["prot"][0].cpu(), o["prot"][2].cpu()))
                if capture is not None else None)
        stepped = eager_chain(m, batch, **kw)["pharm_x"].cpu()
        handle.remove()
        if eager:
            return stepped, read_launches(), 0, k_out
        gap = float((stepped - out).abs().max())
        check(gap < CHAIN_TOL, f"chain_on: the eager step loop differs "
                               f"from the captured chain by {gap:.3e}")
    return out, launched, corr, k_out


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
                   profile: bool = False, other=None,
                   keep: dict | None = None) -> dict:
    """Drive `cfg` through `PocketSampler.sample_stacked`: a warm-up chain
    (it captures the chain's graphs), then `timed` chains with every
    launch count set to 0 just before and read just after: each chain
    exactly its graph replays, with `expected_launches` replayed and no
    launch made or captured outside them (the graphs reused); then the same weights in fp32 over `cmp_steps` steps,
    1 pocket x 8, on the card and on the CPU with the same injected noise.
    `other` (DiffusionConfig overrides: the other sampling path) also
    holds that fp32 chain against the other path's on the card and prints
    the two paths' bf16 difference. `keep` gets the samples/s of the timed
    chains ('rates') and the centres of the first ('pharm_x', generator
    seed 2). Returns the launch counts of one timed chain (replayed)."""
    from pharmaforge_tpu_torch.data.batch import tile_pocket
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
        launches, outside = read_replayed(), read_launches()
        replays, corr = replay_counts()
        check(launches == want and replays == chain_replays(cfg)
              and not any(outside.values()),
              f"{name}: launches per chain {launches} in {replays} graph "
              f"replays and {outside} outside them, expected {want} in "
              f"{chain_replays(cfg)} and none outside")
        check(corr == want_corr,
              f"{name}: {corr} correction passes per chain, "
              f"expected {want_corr}")
        rates.append(n_pockets * per_pocket / dt)
        if rep == 0 and keep is not None:
            keep.update(rates=rates, pharm_x=sampler.last_output["pharm_x"])
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
            # eager: the fault reads each pass's change on the host
            fault = chain_on(model, dataclasses.replace(cmp_cfg, **other),
                             batch, noise, capture=faulty, eager=True)
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
          f"{launches} in {chain_replays(cfg)} graph replays (launches per "
          f"capture x replays; none outside), correction passes "
          f"{want_corr}; card vs CPU (fp32, "
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


def self_us(e) -> float:
    """An event's own device time in µs."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def device_events(p) -> list:
    """The device-side events of a profile (kernels, copies): the host
    ops that launch them report the same time again, and a user
    annotation on the device (such as the optimizer's step range) spans
    kernels counted already."""
    from torch.autograd import DeviceType
    return [e for e in p.key_averages()
            if e.device_type == DeviceType.CUDA and self_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def profile_run(label: str, fn, name: str) -> None:
    """`fn` once under torch.profiler; prints its wall time, the device's
    busy share, each port kernel's time per launch and the 12 kernels that
    take the most device time. With PROFILE_TABLES set, every device
    kernel's count and time go to PROFILE_TABLES/<name>.json."""
    from torch.profiler import ProfilerActivity, profile as prof
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(p)
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
    n_bytes, n_ops, n_rows = ppm.message_agg_cost(*args, **kw)
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
                before = read_launches()["pp_message"]
                got = ppm.fused_message_agg(*args, **kw)
                want = ppm.message_agg_reference(*args, **kw)
                torch.cuda.synchronize()
                check(read_launches()["pp_message"] == before + 1,
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
            before = read_launches()["pp_message_bwd"]
            got = ppbwd_grads(args, kw, True, cot)
            torch.cuda.synchronize()
            check(read_launches()["pp_message_bwd"] == before + 1,
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


# ----------------------------------------------------------------- graphs

@contextlib.contextmanager
def step_index_frozen():
    """A planted fault: every chain step puts the chain's step counter
    back after advancing it, so a captured chain replays step 0 (its
    coefficients, timestep and noise) at every step: what a step that
    read per-step Python values would bake into its graph."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    real = PharmacophoreDiffusion.chain_step

    def frozen(self, chain):
        real(self, chain)
        chain.state["i"].sub_(1)

    PharmacophoreDiffusion.chain_step = frozen
    try:
        yield
    finally:
        PharmacophoreDiffusion.chain_step = real


def timed_call(fn) -> tuple:
    """(fn(), host seconds to its end on the device)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def replay_ms(model) -> float:
    """Device milliseconds of the replays alone of `model`'s kept chain
    graphs (CUDA events around `ChainGraphs.run`)."""
    graphs, = model._chain_graphs.graphs.values()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graphs.run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def captured_call(name: str, model, batch, kw: dict, corrected: bool,
                  cached: bool) -> tuple:
    """One `sample_given_receptor` call of `model` on the card, every count
    set to 0 just before: exactly `expected_launches` replayed in
    `chain_replays` graph replays (each graph's captured launches x its
    replays) and, where the graphs were `cached`, nothing launched or
    captured outside them; a first call launches its warm-up step and
    captures U steps (and the T mod U left). Returns (final pharm_x on
    the host, seconds)."""
    cfg = model.config
    reset_launches()
    out, secs = timed_call(
        lambda: model.sample_given_receptor(batch, **kw)["pharm_x"].cpu())
    replayed, outside = read_replayed(), read_launches()
    replays, corr = replay_counts()
    want = expected_launches(cfg, corrected)
    per_step = {k: v // cfg.n_timesteps for k, v in want.items()}
    u = min(max(1, cfg.sample_scan_unroll), cfg.n_timesteps)
    captured = {k: 0 if cached else v * (1 + u + cfg.n_timesteps % u)
                for k, v in per_step.items()}
    check(replayed == want and replays == chain_replays(cfg)
          and corr == (cfg.n_timesteps if corrected else 0)
          and outside == captured,
          f"graphs {name}: replayed {replayed} in {replays} replays with "
          f"{corr} correction passes, {outside} outside them; expected "
          f"{want} in {chain_replays(cfg)}, {captured} outside")
    return out, secs


def phase_graphs(dev, n_pockets: int = 8, fs_pockets: int = 4,
                 per_pocket: int = 30, atoms: int = 230, turns: int = 3,
                 unrolls: tuple = (4, 7), dev_cfg=None, fs_cfg=None,
                 wide_cfg=None, profile: bool = False) -> dict:
    """The reverse chain as CUDA graphs (`models/diffusion.py::ChainGraphs`)
    against the eager step loop (`eager_chain`) on the card, with the
    same injected noise (generator seeds 3-6), every pair within the
    chain tolerance 2e-3, the largest difference printed:

    * the dev model (`dev_config`, fp32, T=100, random weights, seed 0),
      `n_pockets` x `per_pocket` (B=240): captured against eager; the
      first call (warm-up step and capture) and a later one (the graphs
      kept and reused: nothing launched outside their replays); U in
      `unrolls` (4; 7, which does not divide T: a tail graph) against
      U=1; a planted fault (`step_index_frozen`), which must miss by at
      least 10 x the tolerance, printed in units of it;
    * the full-scale model (`full_config`, bf16, T=1000, the correction
      with the probed k_out), `fs_pockets` x `per_pocket` (B=120):
      captured against eager; U=7 against U=1; the same model with the
      step tables, captured against eager;
    * exact counts of every captured call (`captured_call`);
    * capture time, graph pool bytes (U=1 and the largest U), and the
      per-call overhead of a kept-graphs call: its wall beyond its
      replays' device time;
    * samples/s in alternating turns, `turns` of each: dev eager against
      captured (plain, captured, captured, plain, ...); full scale eager,
      captured and captured with tables; then captured only, the compact
      tail against full width (`fullwidth_config`, T=100).
      `profile` adds device kernels and busy share of a captured and an
      eager T=20 full-scale chain under torch.profiler.

    Returns {kind: samples/s per turn}."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    dev_cfg = dev_cfg or dev_config()
    fs_cfg = fs_cfg or full_config()
    sizes = np.random.default_rng(0).integers(3, 9, per_pocket)
    lines, rates = [], {}

    def build(cfg, state=None, **over):
        m = PharmacophoreDiffusion(
            dataclasses.replace(cfg, **over), device=dev,
            generator=None if state else torch.Generator().manual_seed(0))
        if state:
            m.load_state_dict(state)
        return m

    def setup(cfg, pockets: int, seed: int):
        model = build(cfg)
        pk = synthetic_pockets(pockets, atoms)
        batch = stacked_batch(pk, sizes, atoms)
        k_out = stacked_k_out(model, pk, atoms)
        kw = dict(noise=chain_noise(batch.batch_size, cfg.n_timesteps,
                                    seed=seed),
                  pocket_group_size=per_pocket, pp_k_out=k_out)
        return model, batch, kw, k_out

    def stats(model) -> str:
        g, = model._chain_graphs.graphs.values()
        return (f"capture {g.capture_ms:.1f} ms host (warm-up step "
                f"included), pool {g.pool_bytes} bytes, per capture "
                f"{[c for _, _, c in g.graphs]}")

    def diff(a, b) -> float:
        return float((a - b).abs().max())

    def turns_of(kinds: dict, b: int, outs: dict | None = None) -> dict:
        """samples/s of each kind in alternating turns (ABBA...); `outs`
        gets each kind's outputs."""
        out = {k: [] for k in kinds}
        order = list(kinds)
        seq = []
        for t in range(turns):
            seq += order if t % 2 == 0 else order[::-1]
        for k in seq:
            got, secs = timed_call(kinds[k])
            out[k].append(b / secs)
            if outs is not None:
                outs.setdefault(k, []).append(got)
        return out

    # ---- the dev model
    model, batch, kw, _ = setup(dev_cfg, n_pockets, 3)
    b = batch.batch_size
    state = model.state_dict()
    eager = eager_chain(model, batch, **kw)["pharm_x"].cpu()
    first, first_s = captured_call("dev first", model, batch, kw, False,
                                   cached=False)
    again, again_s = captured_call("dev kept", model, batch, kw, False,
                                   cached=True)
    rep_ms = replay_ms(model)
    err = diff(first, eager)
    check(err < CHAIN_TOL and diff(again, eager) < CHAIN_TOL,
          f"graphs dev: captured vs eager {err:.3e}")
    dev_stats = stats(model)
    with step_index_frozen():
        faulty = build(dev_cfg, state).sample_given_receptor(
            batch, **kw)["pharm_x"].cpu()
    # a chain that rereads step 0 may overflow: a non-finite value misses
    # by infinitely many tolerances
    units = float(torch.nan_to_num((faulty - eager).abs(), nan=np.inf)
                  .max()) / CHAIN_TOL
    check(units >= 10, f"graphs dev: with the step index frozen the chain "
                       f"differs by {units:.3f} x the tolerance, below 10")
    unrolled = []
    for u in unrolls:
        m = build(dev_cfg, state, sample_scan_unroll=u)
        got, secs = captured_call(f"dev U={u}", m, batch, kw, False,
                                  cached=False)
        d = diff(got, first)
        check(d < CHAIN_TOL, f"graphs dev U={u}: {d:.3e} from U=1")
        unrolled.append(f"U={u} {chain_replays(m.config)} replays, max|dx| "
                        f"{d:.3e} from U=1, first call {secs:.3f} s, "
                        f"{stats(m)}")
        del m
    rates["dev"] = turns_of({
        "eager": lambda: eager_chain(model, batch, **kw)["pharm_x"].cpu(),
        "captured": lambda: model.sample_given_receptor(
            batch, **kw)["pharm_x"].cpu()}, b)
    lines.append(
        f"dev (fp32, T={dev_cfg.n_timesteps}, B={b}): captured vs eager "
        f"max|dx| {err:.3e} (tolerance {CHAIN_TOL}); first call "
        f"{first_s:.4f} s, kept graphs {again_s:.4f} s of which replays "
        f"{rep_ms:.3f} ms on the device (per-call overhead "
        f"{again_s * 1e3 - rep_ms:.3f} ms); {dev_stats}; planted fault "
        f"(step index frozen) max|dx| {units * CHAIN_TOL:.3e} = "
        f"{units:.2f} x the tolerance; " + "; ".join(unrolled))
    del model

    # ---- the full-scale model
    model, batch, kw, k_out = setup(fs_cfg, fs_pockets, 5)
    check(k_out > 0, f"graphs: the correction does not engage (k_out "
                     f"{k_out})")
    b = batch.batch_size
    state = model.state_dict()
    first, first_s = captured_call("fullscale first", model, batch, kw,
                                   True, cached=False)
    fs_stats = stats(model)
    again, again_s = captured_call("fullscale kept", model, batch, kw, True,
                                   cached=True)
    rep_ms = replay_ms(model)
    u = max(unrolls)
    m = build(fs_cfg, state, sample_scan_unroll=u)
    got, u_s = captured_call(f"fullscale U={u}", m, batch, kw, True,
                             cached=False)
    u_err = diff(got, first)
    check(u_err < CHAIN_TOL, f"graphs fullscale U={u}: {u_err:.3e} from "
                             f"U=1")
    u_stats = stats(m)
    del m
    tab = build(fs_cfg, state, precompute_step_tables=True)
    tab_first, tab_s = captured_call("tables first", tab, batch, kw, True,
                                     cached=False)
    tab_eager = eager_chain(tab, batch, **kw)["pharm_x"].cpu()
    tab_err = diff(tab_first, tab_eager)
    check(tab_err < CHAIN_TOL, f"graphs tables: captured vs eager "
                               f"{tab_err:.3e}")
    # the eager turns are the chains the captured one is held against
    outs: dict = {}
    rates["fullscale"] = turns_of({
        "eager": lambda: eager_chain(model, batch, **kw)["pharm_x"].cpu(),
        "captured": lambda: captured_call("fullscale turn", model, batch, kw,
                                          True, cached=True)[0],
        "captured tables": lambda: captured_call(
            "tables turn", tab, batch, kw, True, cached=True)[0]}, b, outs)
    err = max(diff(c, e) for c in [first, again] + outs["captured"]
              for e in outs["eager"])
    check(err < CHAIN_TOL, f"graphs fullscale: captured vs eager {err:.3e}")
    lines.append(
        f"fullscale ({fs_cfg.compute_dtype}, T={fs_cfg.n_timesteps}, B={b}, "
        f"k_out {k_out}): captured vs eager max|dx| {err:.3e}; first call "
        f"{first_s:.4f} s, kept graphs {again_s:.4f} s of which replays "
        f"{rep_ms:.3f} ms on the device (per-call overhead "
        f"{again_s * 1e3 - rep_ms:.3f} ms); U=1 {fs_stats}; U={u} "
        f"{chain_replays(dataclasses.replace(fs_cfg, sample_scan_unroll=u))}"
        f" replays, max|dx| {u_err:.3e} from U=1, first call {u_s:.4f} s, "
        f"{u_stats}; step tables captured vs eager max|dx| {tab_err:.3e}, "
        f"first call {tab_s:.4f} s")
    if profile:
        short = dict(kw, noise=chain_noise(b, 20, seed=6))
        for name, m in (("captured", build(fs_cfg, state, n_timesteps=20)),
                        ("eager", build(fs_cfg, state, n_timesteps=20))):
            run = (lambda: m.sample_given_receptor(batch, **short)) \
                if name == "captured" else \
                (lambda: eager_chain(m, batch, **short))
            run()
            n, busy, wall = device_kernels(run)
            lines.append(f"profile {name} T=20: {n} device kernels and "
                         f"copies, busy {busy:.4f} s of {wall:.4f} s "
                         f"({100 * busy / wall:.1f}%)")
    del model, tab

    # ---- compact tail against full width, captured
    wide_cfg = wide_cfg or fullwidth_config()
    compact_cfg = dataclasses.replace(wide_cfg, compact_prot_tail=True)
    runs = {}
    for name, cfg in (("compact", compact_cfg), ("full width", wide_cfg)):
        m = build(cfg, state)
        pk = synthetic_pockets(fs_pockets, atoms)
        kw_c = dict(noise=chain_noise(b, cfg.n_timesteps, seed=6),
                    pocket_group_size=per_pocket,
                    pp_k_out=stacked_k_out(m, pk, atoms))
        captured_call(f"{name} first", m, batch, kw_c, kw_c["pp_k_out"] > 0,
                      cached=False)
        runs[name] = (lambda m=m, kw_c=kw_c, name=name: captured_call(
            f"{name} turn", m, batch, kw_c, kw_c["pp_k_out"] > 0,
            cached=True)[0])
    rates["compact vs full width"] = turns_of(runs, b)
    del runs

    def fmt(r: dict) -> str:
        return ", ".join(f"{k} {' '.join(f'{x:.4f}' for x in v)} (median "
                         f"{float(np.median(v)):.4f})" for k, v in r.items())

    print(f"graphs: on {card()}: " + "; ".join(lines)
          + "; samples/s in alternating turns: "
          + "; ".join(f"{kind}: {fmt(r)}" for kind, r in rates.items())
          + f" (compact and full width at T={wide_cfg.n_timesteps})",
          flush=True)
    return rates


# -------------------------------------------------------------- fullscale

def phase_fullscale(dev, profile: bool = False,
                    keep: dict | None = None) -> dict:
    return phase_sampling("fullscale", dev, full_config(), n_pockets=4,
                          per_pocket=30, atoms=230, timed=2, cmp_steps=20,
                          profile=profile, keep=keep)


def phase_fullwidth(dev, profile: bool = False) -> dict:
    return phase_sampling("fullwidth", dev, fullwidth_config(),
                          n_pockets=4, per_pocket=30, atoms=230, timed=1,
                          cmp_steps=20, profile=profile,
                          other=dict(compact_prot_tail=True))


# ----------------------------------------------------------------- tables

class FirstCall(Exception):
    """Ends a chain at its first denoiser call (`first_call`)."""


@contextlib.contextmanager
def first_call(model, kept: list, state: list):
    """Inside the block, `model`'s eager chain (`eager_chain`: the hooks
    copy to the host) stops at its first denoiser call,
    whose outputs (eps_h, eps_x) go to `kept` and the second conv's output
    there (prot scalars and vectors, pharm scalars and vectors) to
    `state`."""
    def hook(mod, args, out):
        kept.append(tuple(o.detach().cpu() for o in out))
        raise FirstCall

    def conv_hook(mod, args, out):
        state.append(tuple(out[nt][i].detach().cpu()
                           for nt in ("prot", "pharm") for i in (0, 2)))

    handles = [model.dynamics.register_forward_hook(hook),
               model.dynamics.noise_predictor.conv_layers[1]
               .register_forward_hook(conv_hook)]
    try:
        yield
    except FirstCall:
        pass
    finally:
        for handle in handles:
            handle.remove()


@contextlib.contextmanager
def tables_misordered():
    """A planted fault: the step tables are built with the chain's
    timesteps reversed, so step i reads step T-1-i's tables."""
    from pharmaforge_tpu_torch.models import diffusion
    real = diffusion.precompute_sampling_tables
    diffusion.precompute_sampling_tables = \
        lambda dyn, h, m, ed, tv, chunk: real(dyn, h, m, ed, tv.flip(0),
                                              chunk)
    try:
        yield
    finally:
        diffusion.precompute_sampling_tables = real


@contextlib.contextmanager
def tables_rolled():
    """A planted fault: the step tables are built from the pocket groups
    rolled by one, so every copy reads another pocket's tables."""
    from pharmaforge_tpu_torch.models import diffusion
    from pharmaforge_tpu_torch.models.edges import EdgeData
    real = diffusion.precompute_sampling_tables

    def rolled(dyn, h, m, ed, tv, chunk):
        return real(dyn, h.roll(1, 0), m.roll(1, 0),
                    EdgeData(*(a.roll(1, 0) for a in ed)), tv, chunk)

    diffusion.precompute_sampling_tables = rolled
    try:
        yield
    finally:
        diffusion.precompute_sampling_tables = real


def stacked_batch(pockets, sizes, atoms: int):
    """The batch `PocketSampler.sample_stacked` makes: every pocket tiled
    over `sizes`, pocket-major."""
    from pharmaforge_tpu_torch.data.batch import concat_batches, tile_pocket
    return concat_batches([tile_pocket(p["prot_x"], p["prot_h"], sizes,
                                       max_pharm=8, max_prot=atoms)
                           for p in pockets])


def chain_noise(b: int, steps: int, seed: int = 3) -> dict:
    """Injected draws of a chain of `steps` steps over `b` rows."""
    rng = np.random.default_rng(seed)
    noise = {"x_T": rng.normal(size=(b, 8, 3)),
             "h_T": rng.normal(size=(b, 8, 6)),
             "pos": rng.normal(size=(steps, b, 8, 3)),
             "feat": rng.normal(size=(steps, b, 8, 6))}
    return {k: v.astype(np.float32) for k, v in noise.items()}


def out_err(want, got) -> tuple:
    """(max |got - want|, max of |got - want| / (atol + rtol |want|)) at
    the conv tolerance over paired tensors: the second is the excess in
    units of the tolerance, at most 1 within it."""
    err, units = 0.0, 0.0
    for w, g in zip(want, got):
        d = (g - w).abs()
        err = max(err, float(d.max()))
        units = max(units, float((d / (CONV_TOL["atol"]
                                       + CONV_TOL["rtol"] * w.abs())).max()))
    return err, units


def device_kernels(fn) -> tuple:
    """(device kernels and copies, device busy seconds, wall seconds) of
    `fn` once under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as prof
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(p)
    return (sum(e.count for e in events),
            sum(self_us(e) for e in events) / 1e6, wall)


def phase_tables(dev, n_pockets: int = 4, per_pocket: int = 30,
                 atoms: int = 230, cmp_steps: int = 100,
                 kernel_steps: tuple = (10, 20), cfg=None,
                 per_step: dict | None = None) -> dict:
    """The step tables (`precompute_step_tables`) on the full-scale
    sampling model (`full_config`, bf16, correction on), 4 pockets x 30:

    * the build alone at T=1000: its bytes (the tensors' bytes equal the
      JAX budget count), chunks and peak device memory;
    * the first denoiser call of a T=1000 chain in fp32, tables against
      the per-step chain (same weights, batch and noise): its outputs and
      the second conv's state at the conv tolerance; with the tables
      misordered (`tables_misordered`, a planted fault) its outputs
      outside it, and with the tables built from the pocket groups rolled
      by one (`tables_rolled`) the outputs or the state at least 10 x
      outside it, each excess printed in units of the tolerance;
    * an fp32 chain of `cmp_steps` steps, tables on against off, final
      coordinates within the chain tolerance;
    * a bf16 T=1000 chain of each path through
      `PocketSampler.sample_stacked` (generator seed 2) after a call that
      captures its graphs: samples/s of both, exactly 1,000 K1, 3,000 K2
      and 1,000 correction passes in each (graph replays), the final
      coordinates' deviation printed only. `per_step` (the fullscale
      phase's `keep`: the same model, pockets and seed) stands for the
      per-step chain where given;
    * device kernels per step of each path: profiled eager step loops
      (`eager_chain`, the kernels a captured step holds) of
      `kernel_steps` lengths, the difference over the extra steps.

    Returns the launches of the T=1000 tables chain."""
    from pharmaforge_tpu_torch.models.diffusion import (
        PharmacophoreDiffusion, step_table_plan)
    from pharmaforge_tpu_torch.models.dynamics import (
        precompute_sampling_tables)
    from pharmaforge_tpu_torch.models.edges import build_pp_edge
    from pharmaforge_tpu_torch.training.sampling import PocketSampler

    off_cfg = cfg or full_config()
    on_cfg = dataclasses.replace(off_cfg, precompute_step_tables=True)
    model = PharmacophoreDiffusion(
        on_cfg, device=dev, generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    pockets = synthetic_pockets(n_pockets, atoms)
    sizes = np.random.default_rng(0).integers(3, 9, per_pocket)
    n_pharms = [sizes] * n_pockets
    batch = stacked_batch(pockets, sizes, atoms)
    c, b = per_pocket, batch.batch_size
    k_out = stacked_k_out(model, pockets, atoms)
    check(k_out > 0, f"tables: the correction does not engage (k_out "
                     f"{k_out})")

    # the build alone
    px = torch.as_tensor(batch.prot_x[::c], device=dev)
    pm = torch.as_tensor(batch.prot_mask[::c], device=dev)
    ph = torch.as_tensor(batch.prot_h[::c], device=dev)
    _, ed_g = build_pp_edge(px, pm, model.cutoffs["pp"], on_cfg.pp_k_max)
    g, p, k = ed_g.mask.shape
    table_bytes, chunk = step_table_plan(on_cfg, g, p, k)
    t_values = torch.arange(on_cfg.n_timesteps, 0, -1, device=dev,
                            dtype=torch.float32) / on_cfg.n_timesteps
    if dev.type == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tables = precompute_sampling_tables(model.dynamics, ph, pm, ed_g,
                                        t_values, chunk)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = (f"{torch.cuda.max_memory_allocated() - base} bytes above "
                f"the {base} held before")
    else:
        peak = "not measured (no card)"
    build_s = time.perf_counter() - t0
    held = sum(a.numel() * a.element_size() for a in tables
               if a is not None)
    check(held == table_bytes <= on_cfg.precompute_table_budget,
          f"tables: {held} bytes held, the plan counts {table_bytes}")
    chunks = -(-on_cfg.n_timesteps // chunk)
    del tables

    # the first denoiser call in fp32, same inputs and noise
    noise = chain_noise(b, off_cfg.n_timesteps)

    def first(on: bool, fault=contextlib.nullcontext):
        m = PharmacophoreDiffusion(dataclasses.replace(
            off_cfg, compute_dtype="float32", precompute_step_tables=on),
            device=dev)
        m.load_state_dict(state)
        kept, conv_state = [], []
        with fault(), first_call(m, kept, conv_state):
            # the eager step loop: the hooks copy to the host
            eager_chain(m, batch, noise=noise, pocket_group_size=c,
                        pp_k_out=k_out)
        check(len(kept) == len(conv_state) == 1,
              "tables: no first denoiser call kept")
        return kept[0], conv_state[0]

    # the outputs of a random-weight model barely see the pocket context,
    # so the second conv's state is held too (as the fullwidth phase holds
    # it for the correction)
    want, want_state = first(False)
    got, got_state = first(True)
    step_err, step_units = out_err(want + want_state, got + got_state)
    check(step_units <= 1, f"tables: the first denoiser call with tables "
                           f"differs by {step_err:.3e}, beyond {CONV_TOL}")
    got, got_state = first(True, tables_misordered)
    fault_err, fault_units = out_err(want, got)
    check(fault_units > 1, f"tables: with the tables misordered the first "
                           f"call differs by {fault_err:.3e}, within "
                           f"{CONV_TOL}: the comparison cannot see it")
    fault_state = out_err(want_state, got_state)
    got, got_state = first(True, tables_rolled)
    roll_out, roll_state = out_err(want, got), out_err(want_state, got_state)
    roll_units = max(roll_out[1], roll_state[1])
    check(roll_units >= 10, f"tables: with the pocket groups rolled the "
                            f"first call's outputs differ by "
                            f"{roll_out[0]:.3e} and the second conv's state "
                            f"by {roll_state[0]:.3e}, {roll_units:.3f} x "
                            f"{CONV_TOL}: below 10 x")

    # an fp32 chain of cmp_steps, tables on against off
    short = dataclasses.replace(off_cfg, n_timesteps=cmp_steps,
                                compute_dtype="float32")
    short_noise = chain_noise(b, cmp_steps, seed=4)
    finals = []
    for on in (True, False):
        m = PharmacophoreDiffusion(dataclasses.replace(
            short, precompute_step_tables=on), device=dev)
        m.load_state_dict(state)
        finals.append(m.sample_given_receptor(
            batch, noise=short_noise, pocket_group_size=c,
            pp_k_out=k_out)["pharm_x"].cpu())
    chain_dev = float((finals[0] - finals[1]).abs().max())
    check(chain_dev < CHAIN_TOL, f"tables: the fp32 T={cmp_steps} chain "
                                 f"with tables differs by {chain_dev:.3e}")

    # a bf16 chain of each path through the sampler, timed
    rates, outs, launches = {}, {}, None
    gen = torch.Generator(device=dev)
    want_launches = expected_launches(on_cfg, corrected=True)
    runs = (("per-step", off_cfg), ("tables", on_cfg))
    if per_step is not None:
        rates["per-step"] = per_step["rates"][0]
        outs["per-step"] = per_step["pharm_x"]
        runs = runs[1:]
    for name, run_cfg in runs:
        m = PharmacophoreDiffusion(run_cfg, device=dev)
        m.load_state_dict(state)
        sampler = PocketSampler(m, fixed_prot_slots=atoms, device=dev)
        gen.manual_seed(1)
        sampler.sample_stacked(pockets, n_pharms, gen)   # capture
        gen.manual_seed(2)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        sampler.sample_stacked(pockets, n_pharms, gen)
        torch.cuda.synchronize()
        rates[name] = n_pockets * per_pocket / (time.perf_counter() - t0)
        counts = read_replayed()
        check(counts == want_launches
              and replay_counts() == (chain_replays(run_cfg),
                                      run_cfg.n_timesteps)
              and not any(read_launches().values()),
              f"tables: {name} chain launches {counts} in "
              f"{replay_counts()} graph replays and correction passes, "
              f"{read_launches()} outside them, expected {want_launches}")
        outs[name] = sampler.last_output["pharm_x"]
        launches = counts
    bf16_dev = float(np.abs(outs["tables"] - outs["per-step"]).max())

    # device kernels per step of each path
    per_step = {}
    for name, run_cfg in (("per-step", off_cfg), ("tables", on_cfg)):
        found = []
        for steps in kernel_steps:
            m = PharmacophoreDiffusion(dataclasses.replace(
                run_cfg, n_timesteps=steps), device=dev)
            m.load_state_dict(state)
            gen.manual_seed(5)
            # the eager step loop: the kernels one captured step holds
            found.append(device_kernels(lambda: eager_chain(
                m, batch, generator=gen, pocket_group_size=c,
                pp_k_out=k_out)))
        (n0, _, _), (n1, busy1, wall1) = found
        extra = kernel_steps[1] - kernel_steps[0]
        per_step[name] = (f"{(n1 - n0) / extra:.1f} device kernels and "
                          f"copies a step (T={kernel_steps[0]} and "
                          f"T={kernel_steps[1]} chains: {n0} and {n1}), "
                          f"busy {busy1:.4f} s of {wall1:.4f} s in the "
                          f"longer")
    print(f"tables: full-scale model ({off_cfg.compute_dtype}, n_convs="
          f"{off_cfg.n_convs}, correction on, k_out {k_out}), {n_pockets} "
          f"pockets x {per_pocket} (B={b}) on {card()}: the build at "
          f"T={on_cfg.n_timesteps} {table_bytes} bytes of tables (G={g}, "
          f"P={p}, K={k}) in {chunks} chunks of {chunk} steps, "
          f"{build_s:.4f} s, peak device memory {peak}; first denoiser "
          f"call (fp32, T={off_cfg.n_timesteps}) tables vs per-step max|d| "
          f"{step_err:.3e} over the outputs and the second conv's state "
          f"(tolerance {CONV_TOL}; {step_units:.4f} x it); planted faults, "
          f"max|d| (x the tolerance): tables misordered outputs "
          f"{fault_err:.3e} ({fault_units:.4f} x), state "
          f"{fault_state[0]:.3e} ({fault_state[1]:.4f} x); pocket groups "
          f"rolled by one outputs {roll_out[0]:.3e} ({roll_out[1]:.4f} x), "
          f"state {roll_state[0]:.3e} ({roll_state[1]:.4f} x); fp32 "
          f"T={cmp_steps} chain "
          f"tables on vs off final coords max|dx| {chain_dev:.3e} "
          f"(tolerance {CHAIN_TOL}); {off_cfg.compute_dtype} "
          f"T={on_cfg.n_timesteps} chains samples/s per-step "
          f"{rates['per-step']:.4f}, tables {rates['tables']:.4f}, final "
          f"coords max|dx| {bf16_dev:.3e} (printed only); each chain "
          f"launched {launches} with {on_cfg.n_timesteps} correction "
          f"passes; per-step path {per_step['per-step']}; tables path "
          f"{per_step['tables']}", flush=True)
    return launches


# ------------------------------------------------------------------ train

PER_STEP = {"knn_select": 1, "pp_message": 2, "pp_message_bwd": 2}


def train_config(data_dir: str, max_epochs: int = 2, dropout: float = 0.1,
                 batch_size: int = 32) -> dict:
    """The reference-size model as `bench.py`'s full-scale training bench
    builds it (bench.py:456-465): n_convs=4, 128 scalars, 16 vectors,
    3/2/4 message/update/noise GVPs, pf_k=5, pp_k_max=16, dropout 0.1,
    endpoint parameterization, fp32, T=1000; batch 32, validation on
    split 2, one sampling evaluation in two epochs (8 pockets x 2), 8
    optimizer steps a call (`steps_per_call`, configs/dev.yml's)."""
    return {
        "training": {"batch_size": batch_size, "validation_splits": [2],
                     "steps_per_call": 8,
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


def scaled(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items()}


def record_call(trainer, real, batches, calls: list):
    """`real(batches)`, one train call of `trainer`, with its record
    appended to `calls`: its steps, whether it ran captured and built a
    train graph, the launches its graphs replayed
    (`read_train_replayed`) and those the wrappers counted (a built
    graph's warm-up step and capture, or eager steps), and its host
    wall."""
    from pharmaforge_tpu_torch.training.train_state import captured
    kept = {id(g) for g in trainer.optimizer.train_graphs.graphs.values()}
    before, rep_before = read_launches(), read_train_replayed()
    t0 = time.perf_counter()
    out = real(batches)
    wall = time.perf_counter() - t0
    after, rep_after = read_launches(), read_train_replayed()
    calls.append({
        "steps": len(batches), "wall": wall,
        "captured": captured(trainer.device),
        "built": any(id(g) not in kept
                     for g in trainer.optimizer.train_graphs.graphs.values()),
        "launched": {k: after[k] - before[k] for k in after},
        "replayed": {k: rep_after[k] - rep_before[k] for k in rep_after}})
    return out


def count_calls(trainer, calls: list) -> None:
    """Wrap `trainer.train_call` so each call's record (`record_call`)
    goes to `calls`."""
    real = trainer.train_call
    trainer.train_call = lambda batches: record_call(trainer, real, batches,
                                                     calls)


def check_calls(name: str, calls: list) -> int:
    """Every call ran exactly 1 K1, 2 K2 and 2 K3 a step: where captured,
    as its graph's captured launches x its replay, with nothing launched
    outside the replay unless the call built its graph (then the warm-up
    step and the K captured steps); where eager, launched by the
    wrappers. Returns the steps."""
    zero = dict.fromkeys(KERNELS, 0)
    for c in calls:
        k = c["steps"]
        if c["captured"]:
            want = (scaled(PER_STEP, k + 1) if c["built"] else zero,
                    scaled(PER_STEP, k))
        else:
            want = scaled(PER_STEP, k), zero
        check((c["launched"], c["replayed"]) == want,
              f"{name}: a call of {k} steps (captured {c['captured']}, "
              f"built {c['built']}) launched {c['launched']} and replayed "
              f"{c['replayed']}, expected {want}")
    return sum(c["steps"] for c in calls)


def record_validation(trainer, real, datamodule, vals: list):
    """`real(datamodule)`, one validation of `trainer`, with its record
    appended to `vals`: its batches, the validation graphs it built, the
    validation graph replays and the launches they ran
    (`read_eval_replayed`), those the wrappers counted (a built graph's
    warm-up and capture, or eager batches), and its host wall."""
    kept = {id(g) for g in eval_graphs(trainer.model)}
    before, (reps, rep_before) = read_launches(), read_eval_replayed()
    t0 = time.perf_counter()
    out = real(datamodule)
    wall = time.perf_counter() - t0
    after, (reps_after, rep_after) = read_launches(), read_eval_replayed()
    vals.append({
        "batches": trainer.val_batch_count(
            datamodule.val_dataloader(seed=trainer.seed)),
        "wall": wall,
        "built": sum(id(g) not in kept for g in eval_graphs(trainer.model)),
        "replays": reps_after - reps,
        "launched": {k: after[k] - before[k] for k in after},
        "replayed": {k: rep_after[k] - rep_before[k] for k in rep_after}})
    return out


def count_validations(trainer, vals: list) -> None:
    """Wrap `trainer.validate` so each validation's record
    (`record_validation`) goes to `vals`."""
    real = trainer.validate
    trainer.validate = lambda dm: record_validation(trainer, real, dm, vals)


def check_vals(name: str, vals: list, captured: bool) -> int:
    """Every validation ran exactly 1 K1, 2 K2 and 0 K3 a batch: where
    `captured`, each batch one replay of a kept graph, its launches the
    graph's captured launches x its replay, with nothing launched outside
    the replays but each built graph's warm-up and capture; else launched
    by the wrappers, with no replay. Returns the batches."""
    for v in vals:
        n = v["batches"]
        if captured:
            want = (scaled(PER_VAL, 2 * v["built"]), scaled(PER_VAL, n), n)
        else:
            want = (scaled(PER_VAL, n), dict.fromkeys(KERNELS, 0), 0)
        got = (v["launched"], v["replayed"], v["replays"])
        check(n > 0 and got == want and (captured or not v["built"]),
              f"{name}: a validation of {n} batches (built {v['built']} "
              f"graphs) launched, replayed, replays {got}, expected {want}")
    return sum(v["batches"] for v in vals)


def vals_summary(vals: list) -> str:
    """The validations' batches, graphs built and host wall, and the wall
    a batch of those that built no graph, in words."""
    kept = [v for v in vals if not v["built"]]
    batches = sum(v["batches"] for v in kept)
    per_batch = (f"{1e3 * sum(v['wall'] for v in kept) / batches:.3f} ms"
                 if kept else "none")
    return (f"{len(vals)} validations of {sum(v['batches'] for v in vals)} "
            f"batches ({sum(v['replays'] for v in vals)} replays, "
            f"{sum(v['built'] for v in vals)} graphs built, "
            f"{sum(v['wall'] for v in vals):.3f} s; a batch of those that "
            f"built no graph {per_batch})")


def calls_summary(calls: list) -> str:
    """The calls' step counts, captured and built, in words."""
    sizes = [c["steps"] for c in calls]
    return (f"{len(calls)} calls of {sorted(set(sizes))} steps "
            f"({sum(sizes)} steps; {sum(c['captured'] for c in calls)} "
            f"captured, {sum(c['built'] for c in calls)} built a graph)")


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


def fit_records(run_dir) -> list:
    return [json.loads(ln) for ln in
            (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def data_rng_states(dm) -> tuple:
    """The numpy generator states of `dm`'s train and validation datasets
    (their pharmacophore subsampling draws)."""
    return tuple(ds._rng.bit_generator.state
                 for ds in (dm.train_dataset, dm.val_dataset))


def keep_data_rng(dm, epoch: int, kept: dict) -> None:
    """Keep `dm`'s dataset generator states as the fit's epoch `epoch`
    (0-based, Trainer seed 0) opens its loader, in `kept["states"]`."""
    real = dm.train_dataloader

    def loader(seed: int = 0):
        if seed == epoch:
            kept["states"] = data_rng_states(dm)
        return real(seed)

    dm.train_dataloader = loader


def start_data_rng(dm, states: tuple) -> None:
    """Give `dm`'s datasets `states` as `setup` makes them."""
    real = dm.setup

    def setup(stage: str = "fit"):
        real(stage)
        for ds, state in zip((dm.train_dataset, dm.val_dataset), states):
            ds._rng.bit_generator.state = state

    dm.setup = setup


def phase_train(dev, profile: bool = False, config_fn=train_config,
                samples_per_split: int = 144, n_prot_range=(200, 230)
                ) -> tuple:
    """`Trainer.fit` at full scale on the card, 8 steps a call: 2 epochs
    without a stop (one sampling evaluation); then, from the same seed,
    1 epoch and the second resumed from 'last'. Every call replays its
    CUDA graph: exactly 1 K1, 2 K2 and 2 K3 a step as captured launches x
    replays, nothing launched outside the replays but a graph's warm-up
    step and capture (`check_calls`); each epoch one call of 8 steps and
    the leftover singly; losses finite; the checkpoint restores bit-equal
    weights; the resumed epoch's steps agree with the same steps of the
    run without a stop, given that run's dataset generator states at the
    epoch's start (the datasets' pharmacophore subsampling draws from a
    process-lived numpy generator, as in the JAX package, which a
    checkpoint does not keep): losses within rtol 1e-4 (the dist phase's
    metric tolerance), weights at the fp32 train-step tolerance per leaf
    (bit-equality printed); train steps/s over the calls that built no
    graph (a call's wall over its steps; validation and sampling fall
    between calls). Every validation of the three fits replays a kept
    graph a batch: 1 K1, 2 K2 and 0 K3 a batch as captured launches x
    replays, nothing outside them but a graph's warm-up and capture
    (`check_vals`). The first epoch runs again with validation eager
    (`eager_validation`): validation's share of each one-epoch fit's wall
    is printed. Returns the launch counts of the 2-epoch fit: the
    wrappers' (its graphs' warm-up steps and captures, the sampling
    evaluation's capture), its sampling chain's graph replays', its train
    graphs' replays' and (replays, launches) of its validation graphs."""
    import tempfile
    from pharmaforge_tpu_torch.config.load_from_config import (
        data_module_from_config, model_from_config)
    from pharmaforge_tpu_torch.data.synthetic import (
        make_synthetic_processed_dataset)
    from pharmaforge_tpu_torch.training.checkpoints import RunCheckpointer
    from pharmaforge_tpu_torch.training.train_state import captured
    from pharmaforge_tpu_torch.training.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = make_synthetic_processed_dataset(
            f"{tmp}/data", n_splits=3, samples_per_split=samples_per_split,
            n_prot_range=n_prot_range, seed=11)
        gen_s = time.perf_counter() - t0
        config, config1 = (config_fn(str(data)),
                           config_fn(str(data), max_epochs=1))
        dm, kept = data_module_from_config(config), {}
        keep_data_rng(dm, 1, kept)
        model = model_from_config(config, device=dev)
        trainer = Trainer(config, f"{tmp}/straight", device=dev)
        fit_calls, fit_vals = [], []
        count_calls(trainer, fit_calls)
        count_validations(trainer, fit_vals)
        reset_launches()
        t0 = time.perf_counter()
        trainer.fit(model, dm)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches, fit_replayed = read_launches(), read_replayed()
        fit_train_replayed = read_train_replayed()
        fit_eval = read_eval_replayed()
        check_vals("train", fit_vals, captured=captured(dev))
        check(replay_counts()[0] > 0,
              f"train: the sampling evaluation ran no graph replay")
        check(check_calls("train", fit_calls) == trainer.global_step > 0,
              f"train: {calls_summary(fit_calls)}, global step "
              f"{trainer.global_step}")
        sizes = sorted({c["steps"] for c in fit_calls})
        check(sizes[-1] == 8 and len(sizes) > 1,
              f"train: calls of {sizes} steps, expected calls of 8 and "
              f"leftovers")
        slots = {int(dm.train_dataset.prot_size(i))
                 for i in range(len(dm.train_dataset))}
        records = fit_records(f"{tmp}/straight")
        losses = [r[k] for r in records for k in r if "loss" in k]
        check(bool(losses) and bool(np.isfinite(losses).all()),
              "train: non-finite or missing losses")
        validity = [r["validity"] for r in records if "validity" in r]
        check(len(validity) == 1, f"train: {len(validity)} sampling "
                                  f"evaluations in 2 epochs, expected 1")

        first = Trainer(config1, f"{tmp}/run", device=dev)
        first_calls, first_vals = [], []
        count_calls(first, first_calls)
        count_validations(first, first_vals)
        first_model = model_from_config(config1, device=dev)
        t0 = time.perf_counter()
        first.fit(first_model, data_module_from_config(config1))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        check_vals("train first epoch", first_vals, captured=captured(dev))
        # the same epoch with validation eager, as before it was captured
        eager_fit = Trainer(config1, f"{tmp}/eager_validation", device=dev)
        eager_vals: list = []
        count_validations(eager_fit, eager_vals)
        with eager_validation():
            t0 = time.perf_counter()
            eager_fit.fit(model_from_config(config1, device=dev),
                          data_module_from_config(config1))
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
        check_vals("train eager validation", eager_vals, captured=False)
        state, meta = RunCheckpointer(f"{tmp}/run").restore("last")
        check(all(torch.equal(state["model"][k], v.cpu())
                  for k, v in first_model.state_dict().items()),
              "train: the checkpoint does not restore bit-equal weights")
        cmp = card_vs_cpu_step(first_model,
                               next(iter(dm.train_dataloader(0))))
        resumed = Trainer(config, f"{tmp}/run", device=dev)
        resumed_calls, resumed_vals = [], []
        count_calls(resumed, resumed_calls)
        count_validations(resumed, resumed_vals)
        resumed_model = model_from_config(config, device=dev, seed=1)
        dm_resumed = data_module_from_config(config)
        start_data_rng(dm_resumed, kept["states"])
        resumed.fit(resumed_model, dm_resumed, resume_from="last")
        check(resumed.epoch == 2
              and resumed.global_step == trainer.global_step,
              f"train: resumed to epoch {resumed.epoch}, step "
              f"{resumed.global_step}")
        check_calls("train first epoch", first_calls)
        check_calls("train resumed", resumed_calls)
        check_vals("train resumed", resumed_vals, captured=captured(dev))
        # the resumed epoch against the same steps without a stop
        got = {r["step"]: r["train total loss"]
               for r in fit_records(f"{tmp}/run")
               if "train total loss" in r and r["step"] > first.global_step}
        want = {r["step"]: r["train total loss"] for r in records
                if "train total loss" in r and r["step"] > first.global_step}
        check(sorted(got) == sorted(want) and bool(want),
              f"train: resumed steps {sorted(got)}, without a stop "
              f"{sorted(want)}")
        loss_rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
        check(loss_rel <= 1e-4, f"train: resumed losses {loss_rel:.3e} "
                                f"from those without a stop")
        resume_worst, resume_equal = weights_close(
            {k: v.cpu() for k, v in resumed_model.state_dict().items()},
            {k: v.cpu() for k, v in model.state_dict().items()})
        check(resume_worst <= 1, f"train: resumed weights at "
                                 f"{resume_worst:.3f} of the train-step "
                                 f"bound from those without a stop")
        timed_calls = [c for c in fit_calls + first_calls + resumed_calls
                       if not c["built"]]
        rates = sorted(c["steps"] / c["wall"] for c in timed_calls)
        if profile:
            batch = next(iter(dm.train_dataloader(0)))
            resumed.train_call([batch])          # a kept graph of 1 step
            torch.cuda.synchronize()
            profile_run("profile train: one captured optimizer step (B=32)",
                        lambda: resumed.train_call([batch]), "train")
    losses_train = [r["train total loss"] for r in records
                    if "train total loss" in r]
    print(f"train: Trainer.fit on {card()}: {trainer.global_step} steps in "
          f"2 epochs, then {first.global_step} in 1 epoch and "
          f"{resumed.global_step - first.global_step} resumed (epoch 2 "
          f"from 'last'), batch {trainer.batch_size}, pocket slots "
          f"{sorted({max(64, -(-n // 64) * 64) for n in slots})} (atoms "
          f"{min(slots)}-{max(slots)}); the 2-epoch fit "
          f"{calls_summary(fit_calls)} and {vals_summary(fit_vals)}, "
          f"resumed {calls_summary(resumed_calls)} and "
          f"{vals_summary(resumed_vals)}; {PER_VAL} a validation batch as "
          f"captured launches x replays; the first epoch "
          f"{first_s:.3f} s with {vals_summary(first_vals)}, validation "
          f"{sum(v['wall'] for v in first_vals) / first_s:.4f} of the "
          f"fit's wall, again with validation eager {eager_s:.3f} s with "
          f"{vals_summary(eager_vals)}, validation "
          f"{sum(v['wall'] for v in eager_vals) / eager_s:.4f} of the "
          f"fit's wall; train steps/s over "
          f"{len(timed_calls)} calls on kept graphs median "
          f"{float(np.median(rates)):.3f}, min {rates[0]:.3f}, max "
          f"{rates[-1]:.3f}; fit wall {fit_s:.1f} s (validation and one "
          f"sampling evaluation included; validity {validity[0]:.3f}); "
          f"train total loss {losses_train[0]:.4f} -> "
          f"{losses_train[-1]:.4f}, val {meta['monitored']:.4f} after "
          f"epoch 1; {PER_STEP} a step in every call as captured launches "
          f"x replays; the 2-epoch fit's wrappers counted {fit_launches} "
          f"(graphs' warm-up steps and captures, the sampling "
          f"evaluation's capture), its train graphs replayed "
          f"{fit_train_replayed}, its validation graphs {fit_eval[0]} "
          f"times {fit_eval[1]} and its sampling evaluation's graphs "
          f"{fit_replayed}; checkpoint round trip bit-equal; the resumed "
          f"epoch against 2 epochs without a stop: losses max rel "
          f"{loss_rel:.3e} (tolerance 1e-4), weights at "
          f"{resume_worst:.4f} of the train-step bound (bit-equal "
          f"{resume_equal}); {cmp}; dataset generated in {gen_s:.1f} s",
          flush=True)
    return fit_launches, fit_replayed, fit_train_replayed, fit_eval


# -------------------------------------------------------------- trainstep

def train_batches(n: int, batch_size: int = 32, atoms: int = 230,
                  slots: int = 256, seed: int = 0) -> list:
    """`n` training batches of `batch_size` synthetic pockets of `atoms`
    atoms in `slots` slots, 4-8 pharmacophore centres each, as `bench.py`
    makes its train batch."""
    from pharmaforge_tpu_torch.data.batch import collate_complexes
    from pharmaforge_tpu_torch.data.synthetic import make_synthetic_pocket
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        samples = []
        for _ in range(batch_size):
            px, elem = make_synthetic_pocket(rng, np.zeros(3), atoms)
            px = px.astype(np.float32)
            n_ph = int(rng.integers(4, 9))
            samples.append({
                "prot_x": px, "prot_h": np.eye(11, dtype=np.float32)[elem],
                "pharm_x": px[:n_ph] * 0.3,
                "pharm_h": np.eye(6, dtype=np.float32)[
                    rng.integers(0, 6, n_ph)]})
        out.append(collate_complexes(samples, max_prot=slots))
    return out


def train_setup(model, accumulate: int = 1, opt_cls=None) -> tuple:
    """(a copy of `model`, its Adam at 1e-3 with `bench.py`'s weight decay,
    a generator on its device seeded 1): one side of a comparison."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    from pharmaforge_tpu_torch.training.optim import Adam
    m = PharmacophoreDiffusion(model.config, device=model.device)
    m.load_state_dict(model.state_dict())
    opt = (opt_cls or Adam)(m.parameters(), 1e-3, weight_decay=1e-12,
                            accumulate=accumulate)
    return m, opt, torch.Generator(device=m.device).manual_seed(1)


def eager_call(setup, batches: list, lr: float) -> np.ndarray:
    """`batches` as eager steps of `setup` at `lr`: the train loss of
    each."""
    from pharmaforge_tpu_torch.data.batch import stack_batches
    from pharmaforge_tpu_torch.training.train_state import eager_train_steps
    model, opt, gen = setup
    opt.set_lr(lr)
    names, out = eager_train_steps(model, opt, stack_batches(batches), gen)
    return out[:, names.index("train total loss")].cpu().numpy()


def captured_train_call(setup, batches: list, lr: float) -> np.ndarray:
    """`batches` as one `multi_train_step` call of `setup` at `lr` (a CUDA
    graph replay on the card): the train loss of each step."""
    from pharmaforge_tpu_torch.data.batch import stack_batches
    from pharmaforge_tpu_torch.training.train_state import multi_train_step
    model, opt, gen = setup
    return multi_train_step(model, opt, stack_batches(batches), gen,
                            lr)["train total loss"]


def train_miss(eager, e_loss, graphed, g_loss) -> tuple:
    """How far a captured call's result lies from the eager steps', in
    units of the train-step tolerance: (worst ratio over the per-step
    losses at rtol 1e-5 and the weight leaves at 2e-4 max|b| + 2e-5,
    a non-finite miss infinite; whether the generators' states are
    equal)."""
    loss = float(np.max(np.abs(g_loss - e_loss)
                        / (1e-5 * np.abs(e_loss))))
    leaves, _ = weights_close(
        {k: v.cpu() for k, v in graphed[0].state_dict().items()},
        {k: v.cpu() for k, v in eager[0].state_dict().items()})
    worst = max(loss, leaves)
    return (worst if np.isfinite(worst) else float("inf"),
            torch.equal(eager[2].get_state(), graphed[2].get_state()))


def frozen_lr_adam():
    """A planted fault: an Adam whose learning rate is a Python float in
    the inner optimizer's parameter group, which a capture bakes in."""
    from pharmaforge_tpu_torch.training.optim import Adam

    class FrozenLrAdam(Adam):
        def set_lr(self, lr):
            for group in self.opt.param_groups:
                group["lr"] = float(lr)

    return FrozenLrAdam


@contextlib.contextmanager
def stale_batches(setup):
    """A planted fault inside the block: `setup`'s kept train graphs
    replay without the new batches copied in."""
    kept = list(setup[1].train_graphs.graphs.values())
    for graphs in kept:
        graphs.load = lambda *args: None
    try:
        yield
    finally:
        for graphs in kept:
            del graphs.load


def trainstep_model(dev, cfg=None):
    """The train cell's model (`train_config`: n_convs=4, 128 scalars, 16
    vectors, fp32, dropout 0.1), random weights from seed 0."""
    from pharmaforge_tpu_torch.models.diffusion import (
        DiffusionConfig, PharmacophoreDiffusion)
    cfg = cfg or DiffusionConfig.from_config(train_config(""))
    return PharmacophoreDiffusion(
        cfg, device=dev, generator=torch.Generator().manual_seed(0))


def trainstep_cases(dev, model, batches: list, k: int) -> tuple:
    """The captured train call against eager steps (`train_miss`) for each
    case, and the two planted faults. Returns (case lines, fault misses,
    the (eager, captured) pair of K-step setups, its graph kept; after the
    `stale_batches` fault their weights differ)."""
    lines, faults = [], {}

    def compare(name, eager, graphed, calls, want_counts=True):
        for i, (bs, lr) in enumerate(calls):
            kept = {id(g) for g in graphed[1].train_graphs.graphs.values()}
            reset_launches()
            e = eager_call(eager, bs, lr)
            before = read_launches()
            g = captured_train_call(graphed, bs, lr)
            torch.cuda.synchronize()
            launched = {n: read_launches()[n] - before[n] for n in KERNELS}
            built = any(id(x) not in kept
                        for x in graphed[1].train_graphs.graphs.values())
            if want_counts:
                want = (scaled(PER_STEP, len(bs) + 1) if built
                        else dict.fromkeys(KERNELS, 0),
                        scaled(PER_STEP, len(bs)), 1, int(built))
                got = (launched, read_train_replayed(), replay_count("train"),
                       capture_count("train"))
                check(got == want, f"trainstep {name} call {i}: launched, "
                                   f"replayed, replays, captures {got}, "
                                   f"expected {want}")
            worst, gen_equal = train_miss(eager, e, graphed, g)
            check(worst <= 1 and gen_equal,
                  f"trainstep {name} call {i}: at {worst:.3f} of the "
                  f"train-step tolerance, generators equal {gen_equal}")
            new = [x for x in graphed[1].train_graphs.graphs.values()
                   if id(x) not in kept]
            made = (f"built: capture {new[0].capture_ms:.1f} ms, pool "
                    f"{new[0].pool_bytes} B" if new else "kept")
            lines.append(f"{name} call {i} ({len(bs)} steps, lr {lr:g}, "
                         f"phase {graphed[1].mini_step} after, graph "
                         f"{made}): {worst:.4f} of the tolerance, "
                         f"generators equal")

    pair = train_setup(model), train_setup(model)
    compare(f"K={k}", *pair, [(batches[:k], 1e-3), (batches[k:2 * k],
                                                     1e-3)])
    one = train_setup(model), train_setup(model)
    compare("K=1", *one, [(batches[:1], 1e-3), (batches[1:2], 1e-3)])
    del one
    acc = train_setup(model, 3), train_setup(model, 3)
    compare(f"accumulate 3, K={k}", *acc,
            [(batches[:k], 1e-3), (batches[k:2 * k], 1e-3)])
    del acc
    # the planted faults: each must miss by at least 10 x the tolerance
    frozen = train_setup(model), train_setup(model, opt_cls=frozen_lr_adam())
    compare("frozen_lr capture", *frozen, [(batches[:k], 1e-3)],
            want_counts=False)
    e = eager_call(frozen[0], batches[k:2 * k], 1e-4)
    g = captured_train_call(frozen[1], batches[k:2 * k], 1e-4)
    faults["frozen_lr"] = train_miss(frozen[0], e, frozen[1], g)[0]
    del frozen
    # the K-step pair's graph holds the second call's batches
    with stale_batches(pair[1]):
        e = eager_call(pair[0], batches[:k], 1e-3)
        g = captured_train_call(pair[1], batches[:k], 1e-3)
    faults["stale_batches"] = train_miss(pair[0], e, pair[1], g)[0]
    for name, miss in faults.items():
        check(miss >= 10, f"trainstep: the planted fault {name} missed by "
                          f"only {miss:.3f} x the tolerance")
    return lines, faults, pair


def phase_trainstep(dev, profile: bool = False, cfg=None,
                    batch_size: int = 32, atoms: int = 230,
                    slots: int = 256, k: int = 8, turns: int = 2,
                    calls_per_turn: int = 2) -> dict:
    """The train step as one device program (`training/train_state.py::
    TrainGraphs`) at the bench's full-scale train workload: the train
    cell's model, B=32 synthetic pockets of 230 atoms in 256 slots, K=8
    steps a call. A captured call against K eager steps from identical
    weights, Adam state and generator (each step's loss within rtol 1e-5,
    each weight leaf within 2e-4 max|b| + 2e-5, the generators' states
    equal), over a call that builds its graph and one on the kept graph;
    again at K=1 and at accumulate 3 from phases 0 and 2; the planted
    faults `frozen_lr` (the rate captured as a Python float, replayed
    after a 10x cut) and `stale_batches` (replayed without the new
    batches) each at least 10 x the tolerance away (a non-finite miss
    counts as infinite); exactly 1 K1, 2 K2 and 2 K3 a step as captured
    launches x replays, nothing launched outside the replay of a kept
    graph; train steps/s eager against captured in alternating turns,
    capture ms and graph pool bytes; with `profile`, the device's busy
    share of a captured call."""
    model = trainstep_model(dev, cfg)
    batches = train_batches(2 * k, batch_size, atoms, slots)
    lines, faults, (eager, graphed) = trainstep_cases(dev, model, batches,
                                                      k)
    graphs = list(graphed[1].train_graphs.graphs.values())
    # speed: the same K-step calls, eager and on the kept graph, in turns
    rates = {"eager": [], "captured": []}
    order = ["eager", "captured", "captured", "eager"] * turns
    for name in order[:2 * turns]:
        run = eager_call if name == "eager" else captured_train_call
        setup = eager if name == "eager" else graphed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls_per_turn):
            run(setup, batches[(i % 2) * k:(i % 2 + 1) * k], 1e-3)
        torch.cuda.synchronize()
        rates[name].append(calls_per_turn * k / (time.perf_counter() - t0))
    if profile:
        profile_run(f"profile trainstep: one captured call of {k} steps "
                    f"(B={batch_size})",
                    lambda: captured_train_call(graphed, batches[:k], 1e-3),
                    "trainstep")
        profile_run(f"profile trainstep: {k} eager steps (B={batch_size})",
                    lambda: eager_call(eager, batches[:k], 1e-3),
                    "trainstep_eager")
    print(f"trainstep: on {card()}: B={batch_size}, {atoms} atoms in "
          f"{slots} slots, K={k}: " + "; ".join(lines)
          + f"; planted faults {json.dumps(faults)} x the tolerance "
          f"(at least 10); {PER_STEP} a step as captured launches x "
          f"replays, none outside a kept graph's replay; train steps/s in "
          f"turns {order[:2 * turns]}: eager "
          f"{' '.join(f'{r:.3f}' for r in rates['eager'])}, captured "
          f"{' '.join(f'{r:.3f}' for r in rates['captured'])}; the K={k} "
          f"graph: capture {graphs[0].capture_ms:.1f} ms (its warm-up step "
          f"included), pool {graphs[0].pool_bytes} B", flush=True)
    return {"eager": rates["eager"], "captured": rates["captured"],
            "capture_ms": graphs[0].capture_ms,
            "pool_bytes": graphs[0].pool_bytes, "faults": faults}


# --------------------------------------------------------------- evalstep

# the wrappers' launches of one validation batch: eval mode runs the
# compact prot tail, so K2 runs once at full width and once over the
# pf-listed atoms, and no gradient means no K3
PER_VAL = {"knn_select": 1, "pp_message": 2, "pp_message_bwd": 0}
EVAL_RTOL = 1e-5


def read_eval_replayed() -> tuple:
    """(validation graph replays, the launches they ran per kernel: each
    graph's captured launches x its replays)."""
    return replay_count("eval"), replayed("eval")


def metric_miss(want: dict, got: dict) -> float:
    """How far `got`'s metrics lie from `want`'s in units of rtol 1e-5:
    the worst |g - w| / (1e-5 |w|); equal values count 0, a non-finite
    miss infinite."""
    worst = 0.0
    for k, w in want.items():
        err = abs(float(got[k]) - float(w))
        if err == 0:
            continue
        ratio = err / (EVAL_RTOL * abs(float(w))) if w else float("inf")
        worst = max(worst, ratio if np.isfinite(ratio) else float("inf"))
    return worst


def eval_graphs(model) -> list:
    """The validation graphs kept on `model` (`train_state.EvalGraphs`)."""
    return list(model._eval_graphs.graphs.values())


@contextlib.contextmanager
def frozen_weights():
    """A planted fault inside the block: a validation graph built there
    captures a copy of the model's weights as they are at capture (while
    the model's cache still watches the model's own storage), so its
    replays miss every train call after it."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    from pharmaforge_tpu_torch.training import train_state
    real = train_state.EvalGraphs

    class FrozenWeights(real):
        def __init__(self, model, *args):
            frozen = PharmacophoreDiffusion(model.config, device=model.device)
            frozen.load_state_dict(model.state_dict())
            super().__init__(frozen, *args)

    train_state.EvalGraphs = FrozenWeights
    try:
        yield
    finally:
        train_state.EvalGraphs = real


@contextlib.contextmanager
def stale_val_batches(model):
    """A planted fault inside the block: `model`'s kept validation graphs
    replay without the new batch copied in."""
    kept = eval_graphs(model)
    for graphs in kept:
        graphs.load = lambda *args: None
    try:
        yield
    finally:
        for graphs in kept:
            del graphs.load


@contextlib.contextmanager
def eager_validation():
    """Inside the block `Trainer.validate` runs every batch eagerly
    (`train_state.eager_eval`), as it did before validation was
    captured."""
    from pharmaforge_tpu_torch.training import train_state, trainer
    real = trainer.eval_metrics
    trainer.eval_metrics = train_state.eager_eval
    try:
        yield
    finally:
        trainer.eval_metrics = real


def eager_val(setup, batch) -> dict:
    """`batch`'s validation metrics from an eager forward of `setup`'s
    model (`train_state.eager_eval`), as floats."""
    from pharmaforge_tpu_torch.training.train_state import eager_eval
    model, _, gen = setup
    names, out = eager_eval(model, batch, gen)
    return dict(zip(names, out.tolist()))


def captured_val(setup, batch) -> dict:
    """`batch`'s validation metrics through `train_state.eval_step` (a
    CUDA graph replay on the card), as floats."""
    from pharmaforge_tpu_torch.training.train_state import eval_step
    model, _, gen = setup
    return eval_step(model, batch, gen)


def sync_setup(dst, src) -> None:
    """`src`'s weights and generator state into `dst`, in place."""
    dst[0].load_state_dict(src[0].state_dict())
    dst[2].set_state(src[2].get_state())


def evalstep_cases(dev, model, buckets: dict, train: list) -> tuple:
    """Captured validation batches against eager ones from equal weights
    and generator states: each batch of every bucket in two turns, then
    after a captured train call on the kept graphs; exact counts; the two
    planted faults. Returns (case lines, fault misses, the (eager,
    captured) pair, in step)."""
    lines, faults = [], {}
    pair = train_setup(model), train_setup(model)

    def compare(name, eager, graphed, batch, want_counts=True):
        kept = {id(g) for g in eval_graphs(graphed[0])}
        reset_launches()
        e = eager_val(eager, batch)
        check(read_launches() == PER_VAL,
              f"evalstep {name}: the eager batch launched {read_launches()}"
              f", expected {PER_VAL}")
        reset_launches()
        g = captured_val(graphed, batch)
        torch.cuda.synchronize()
        built = [x for x in eval_graphs(graphed[0]) if id(x) not in kept]
        if want_counts:
            replays, replayed = read_eval_replayed()
            want = (scaled(PER_VAL, 2) if built
                    else dict.fromkeys(KERNELS, 0), PER_VAL, 1)
            got = (read_launches(), replayed, replays)
            check(got == want, f"evalstep {name}: launched, replayed, "
                               f"replays {got}, expected {want}")
        miss = metric_miss(e, g)
        gen_equal = torch.equal(eager[2].get_state(), graphed[2].get_state())
        check(miss <= 1 and gen_equal,
              f"evalstep {name}: at {miss:.3f} of rtol {EVAL_RTOL}, "
              f"generators equal {gen_equal}")
        made = (f"built: capture {built[0].capture_ms:.1f} ms, pool "
                f"{built[0].pool_bytes} B" if built else "kept")
        lines.append(f"{name} ({made}): {miss:.4f} of the tolerance")
        return e, g

    for turn in range(2):
        for bucket, batches in buckets.items():
            for i, batch in enumerate(batches):
                compare(f"turn {turn} {bucket} batch {i}", *pair, batch)
    # a captured train call moves the weights in place; the kept graphs
    # must see them
    captured_train_call(pair[1], train, 1e-3)
    sync_setup(pair[0], pair[1])
    for bucket, batches in buckets.items():
        compare(f"after a train call {bucket}", *pair, batches[0])
    # the planted faults: each must miss by at least 10 x the tolerance
    bucket, batches = next(iter(buckets.items()))
    with stale_val_batches(pair[1][0]):
        e, g = eager_val(pair[0], batches[1]), captured_val(pair[1],
                                                              batches[1])
    faults["stale_val_batches"] = metric_miss(e, g)
    frozen = train_setup(model), train_setup(model)
    with frozen_weights():
        compare("frozen_weights capture", *frozen, batches[0],
                want_counts=False)
    eager_call(frozen[1], train, 1e-3)
    sync_setup(frozen[0], frozen[1])
    e, g = eager_val(frozen[0], batches[0]), captured_val(frozen[1],
                                                          batches[0])
    faults["frozen_weights"] = metric_miss(e, g)
    del frozen
    for name, miss in faults.items():
        check(miss >= 10, f"evalstep: the planted fault {name} missed by "
                          f"only {miss:.3f} x the tolerance")
    return lines, faults, pair


def phase_evalstep(dev, cfg=None, batch_size: int = 32,
                   shapes=((230, 256), (180, 192)), n: int = 3,
                   turns: int = 2) -> dict:
    """The validation step as one device program (`training/train_state.py
    ::EvalGraphs`) at the bench's full-scale train shape: the train cell's
    model, B=32 synthetic pockets of 230 atoms in 256 slots, and a second
    bucket of 180 atoms in 192 slots, so two signatures run. Each batch
    eager and captured from equal weights and generator states (every
    metric within rtol 1e-5, the generators' states equal), over the
    calls that build the two graphs, calls on the kept graphs and calls
    after a captured train call; exactly 1 K1, 2 K2 and 0 K3 a batch as
    captured launches x replays, none outside a kept graph's replay; the
    planted faults `stale_val_batches` (replayed without the new batch)
    and `frozen_weights` (captured on a copy of the weights, replayed
    after a train call) each at least 10 x the tolerance away;
    validation batches/s eager against captured in alternating turns,
    capture ms and pool bytes of each graph."""
    model = trainstep_model(dev, cfg)
    buckets = {f"P={slots}": train_batches(n, batch_size, atoms, slots,
                                           seed=10 + i)
               for i, (atoms, slots) in enumerate(shapes)}
    train = train_batches(1, batch_size, *shapes[0], seed=20)
    lines, faults, (eager, graphed) = evalstep_cases(dev, model, buckets,
                                                     train)
    graphs = eval_graphs(graphed[0])
    check(len(graphs) == len(buckets), f"evalstep: {len(graphs)} kept "
                                       f"graphs for {len(buckets)} buckets")
    every = [b for batches in buckets.values() for b in batches]
    rates = {"eager": [], "captured": []}
    order = ["eager", "captured", "captured", "eager"] * turns
    for name in order[:2 * turns]:
        run, setup = ((eager_val, eager) if name == "eager"
                      else (captured_val, graphed))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in every:
            run(setup, batch)
        torch.cuda.synchronize()
        rates[name].append(len(every) / (time.perf_counter() - t0))
    made = {f"P={g.inputs.prot_x.shape[1]}":
            {"capture_ms": round(g.capture_ms, 1), "pool_bytes": g.pool_bytes}
            for g in graphs}
    print(f"evalstep: on {card()}: B={batch_size}, buckets "
          f"{list(buckets)}, {n} batches each: " + "; ".join(lines)
          + f"; planted faults {json.dumps(faults)} x the tolerance (at "
          f"least 10); {PER_VAL} a batch as captured launches x replays, "
          f"none outside a kept graph's replay; validation batches/s in "
          f"turns {order[:2 * turns]} over {len(every)} batches: eager "
          f"{' '.join(f'{r:.3f}' for r in rates['eager'])}, captured "
          f"{' '.join(f'{r:.3f}' for r in rates['captured'])}; "
          f"{len(graphs)} kept graphs {json.dumps(made)} (capture includes "
          f"the warm-up forward; one pool for the model's graphs)",
          flush=True)
    return {"eager": rates["eager"], "captured": rates["captured"],
            "graphs": made, "faults": faults}


# ------------------------------------------------------------------ bench

# the keys of `python -m pharmaforge_tpu_torch.bench`'s line at its default
# workloads: the JAX bench.py's (bench.py:662-727) but
# step_cost_model_gbytes_unfused and torch_executor_samples_per_sec_host_cpu,
# with device, power_limit_w, host_cpu, torch_version and cuda_version
BENCH_KEYS = (
    "metric", "platform", "workload", "value", "unit", "vs_baseline",
    "baseline_samples_per_sec", "spread_min", "spread_max", "repeats",
    "rates_per_repeat", "pipeline_depth", "pockets_per_call",
    "chain_latency_ms", "mfu_vs_bf16_peak", "chain_gflops", "device",
    "power_limit_w", "host_cpu", "torch_version", "cuda_version",
    "train_steps_per_sec", "train_step_device_ms", "train_batch_size",
    "fullscale_train_steps_per_sec", "fullscale_train_step_device_ms",
    "fullscale_train_batch_size", "fullscale_samples_per_sec",
    "fullscale_spread_min", "fullscale_spread_max",
    "fullscale_chain_latency_ms", "fullscale_mfu", "fullscale_vs_baseline",
    "fullscale_workload")


def phase_bench(dev, argv=("--repeats", "2")) -> dict:
    """`pharmaforge_tpu_torch.bench.main` at its default workloads with
    `argv` (it prints its JSON line): every key of BENCH_KEYS, the rates
    positive, the MFU figures at most 1, on this card."""
    from pharmaforge_tpu_torch import bench
    before = replay_count("train")
    res = bench.main(list(argv) + ["--device", str(dev)])
    check(replay_count("train") > before or dev.type != "cuda",
          f"bench: its train steps ran no train graph replay")
    missing = [k for k in BENCH_KEYS if k not in res]
    check(not missing, f"bench: keys missing {missing}")
    rates = [res["value"], res["spread_min"], res["train_steps_per_sec"],
             res["fullscale_samples_per_sec"], res["fullscale_spread_min"],
             res["fullscale_train_steps_per_sec"], *res["rates_per_repeat"]]
    check(all(r > 0 for r in rates), f"bench: rates {rates}")
    mfu = (res["mfu_vs_bf16_peak"], res["fullscale_mfu"])
    check(all(m is not None and 0 < m <= 1 for m in mfu)
          and "timing_suspect" not in res, f"bench: MFU {mfu}")
    check(res["platform"] == "gpu"
          and res["device"] == torch.cuda.get_device_name(dev),
          f"bench: platform {res['platform']}, device {res['device']}")
    print(f"bench: on {card()}: {res['value']} samples/s dev (median of "
          f"{res['repeats']}), {res['fullscale_samples_per_sec']} full "
          f"scale, train steps/s {res['train_steps_per_sec']} / "
          f"{res['fullscale_train_steps_per_sec']} (captured, {replays} "
          f"train graph replays), MFU {mfu}", flush=True)
    return res


# ------------------------------------------------------------------- dist

def dist_config(data_dir: str) -> dict:
    """`train_config`'s model and data for the dist phase: one epoch, no
    sampling evaluation."""
    config = train_config(data_dir, max_epochs=1)
    config["training"]["evaluation"]["sample_interval"] = 0
    return config


def dist_setup(data_dir: str, run_dir: str, device: str, backend,
               config_fn, sample_cfg, pockets, sizes, atoms: int) -> tuple:
    """One setup of the dist phase, in this process (`backend` None: no
    process group) or as a rank of a group: `Trainer.fit` of
    `config_fn(data_dir)` into `run_dir`, then one `PocketSampler.sample_stacked`
    of `sample_cfg` with the trained weights. Returns (launches per
    train call (`record_call`), the weights after the fit, the sampled
    dense centres, the rank, the chain's graph replays on this rank, the
    train steps' mode, `train_state.step_mode`, the validations' records
    (`record_validation`))."""
    from pharmaforge_tpu_torch.config.load_from_config import (
        data_module_from_config, model_from_config)
    from pharmaforge_tpu_torch.models import diffusion
    from pharmaforge_tpu_torch.parallel import mesh
    from pharmaforge_tpu_torch.training.sampling import PocketSampler
    from pharmaforge_tpu_torch.training.train_state import step_mode
    from pharmaforge_tpu_torch.training.trainer import Trainer
    dev = (torch.device(device) if backend is None else
           mesh.init_distributed(device=device, backend=backend))
    config = config_fn(data_dir)
    trainer = Trainer(config, run_dir, device=dev)
    calls, vals = [], []
    count_calls(trainer, calls)
    count_validations(trainer, vals)
    model = model_from_config(config, device=dev)
    trainer.fit(model, data_module_from_config(config))
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    sampler_model = diffusion.PharmacophoreDiffusion(sample_cfg, device=dev)
    sampler_model.load_state_dict(model.state_dict())
    sampler = PocketSampler(sampler_model, fixed_prot_slots=atoms,
                            device=dev)
    before = replay_count("chain")
    sampler.sample_stacked(pockets, [sizes] * len(pockets),
                           torch.Generator(device=dev).manual_seed(7))
    return (calls, weights, sampler.last_output["pharm_x"], mesh.rank(),
            replay_count("chain") - before, step_mode(dev), vals)


def weights_close(got: dict, want: dict) -> tuple:
    """(worst ratio of a leaf's max |a - b| to its fp32 train-step bound
    2e-4 max|b| + 2e-5, bit-equal?) over the weights."""
    worst, equal = 0.0, True
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        worst = max(worst, err / (2e-4 * float(w.abs().max()) + 2e-5))
        equal = equal and torch.equal(got[k], w)
    return worst, equal


def metric_records(run_dir: Path) -> list:
    out = []
    for ln in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(ln)
        rec.pop("time")
        out.append(rec)
    return out


def phase_dist(dev, config_fn=dist_config, samples_per_split: int = 24,
               n_prot_range=(200, 230), sample_steps: int = 50,
               atoms: int = 230, limit_s: float = 600.0) -> dict:
    """Data parallelism (`parallel/mesh.py`) on the card: `dist_setup`
    three ways, from the same seed and data: without a process group, as
    one NCCL rank, and as two gloo ranks sharing the card (NCCL refuses
    two ranks on one device). Each rank runs exactly 1 K1, 2 K2 and 2 K3
    per optimizer step (`check_calls`): captured without a group and as
    the NCCL rank, eagerly on the two gloo ranks (gloo's all-reduce
    cannot be captured; each rank's mode is printed), and likewise 1 K1,
    2 K2 and 0 K3 per validation batch, each batch a replay without a
    group and on the NCCL rank (its all-reduces inside the graph), eager
    on the gloo ranks (`check_vals`); the weights after
    the fit agree with the
    no-group run's at the fp32 train-step tolerance per leaf (whether the
    NCCL run's are bit-equal is printed); rank 0 alone writes (the run
    dirs list the same files, each metric line once, the metrics within
    rtol 1e-4); the no-group run made twice, as the control of
    bit-equality; `sample_stacked` of the full-scale model in fp32 cut to
    `sample_steps` steps, 2 pockets x 8, within the chain tolerance of
    the no-group run's (whose chain takes the pocket-copy correction;
    the two gloo ranks' do not, as in JAX). Returns rank 0's launches
    over the two-rank fit."""
    import tempfile
    from pharmaforge_tpu_torch.data.synthetic import (
        make_synthetic_processed_dataset)
    from pharmaforge_tpu_torch.parallel.mesh import spawn_local
    sample_cfg = dataclasses.replace(full_config(), compute_dtype="float32",
                                     n_timesteps=sample_steps)
    pockets = synthetic_pockets(2, atoms)
    sizes = np.random.default_rng(0).integers(3, 9, 8)
    # both gloo ranks share the one card
    where = "cuda:0" if dev.type == "cuda" else str(dev)
    with tempfile.TemporaryDirectory() as tmp:
        data = str(make_synthetic_processed_dataset(
            f"{tmp}/data", n_splits=3, samples_per_split=samples_per_split,
            n_prot_range=n_prot_range, seed=11))
        args = (config_fn, sample_cfg, pockets, sizes, atoms)
        t0 = time.perf_counter()
        alone = dist_setup(data, f"{tmp}/alone", where, None, *args)
        alone_s = time.perf_counter() - t0
        alone_steps = check_calls("dist without a group", alone[0])
        check(alone_steps > 0 and all(c["captured"] == (dev.type == "cuda")
                                      for c in alone[0]),
              f"dist: without a group {calls_summary(alone[0])}")
        alone_batches = check_vals("dist without a group", alone[6],
                                   captured=dev.type == "cuda")
        # the control: the same run again, still without a group
        again = weights_close(dist_setup(data, f"{tmp}/again", where, None,
                                         *args)[1], alone[1])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        runs = {}
        for name, n, backend in (("nccl", 1, "nccl"), ("gloo", 2, "gloo")):
            t0 = time.perf_counter()
            if dev.type != "cuda":
                backend = "gloo"
            runs[name] = (spawn_local(n, dist_setup, data, f"{tmp}/{name}",
                                      where, backend, *args,
                                      timeout_s=limit_s),
                          time.perf_counter() - t0)
        want_files = sorted(str(q.relative_to(f"{tmp}/alone"))
                            for q in Path(f"{tmp}/alone").rglob("*"))
        want_records = metric_records(Path(f"{tmp}/alone"))
        lines = []
        for name, (ranks, secs) in runs.items():
            run = Path(tmp) / name
            files = sorted(str(q.relative_to(run)) for q in run.rglob("*"))
            check(files == want_files, f"dist {name}: files {files}, "
                                       f"expected {want_files}")
            records = metric_records(run)
            check([sorted(r) for r in records]
                  == [sorted(r) for r in want_records],
                  f"dist {name}: metric lines differ from the no-group "
                  f"run's")
            rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-6)
                      for g, w in zip(records, want_records) for k in w
                      if k != "step")
            check(rel <= 1e-4, f"dist {name}: metrics within {rel:.3e}")
            worst, equal, sample_dev = 0.0, True, 0.0
            modes = []
            for calls, weights, centres, r, replays, mode, vals in ranks:
                want_captured = dev.type == "cuda" and name == "nccl"
                check(check_calls(f"dist {name} rank {r}", calls)
                      == alone_steps and all(
                          c["captured"] == want_captured for c in calls),
                      f"dist {name} rank {r}: {calls_summary(calls)}, "
                      f"expected {alone_steps} steps, captured "
                      f"{want_captured}")
                check(check_vals(f"dist {name} rank {r}", vals,
                                 want_captured) == alone_batches,
                      f"dist {name} rank {r}: {vals_summary(vals)}, "
                      f"expected {alone_batches} batches")
                modes.append(mode)
                # each rank captures and replays its own chain
                want_replays = (chain_replays(sample_cfg)
                                if dev.type == "cuda" else 0)
                check(replays == want_replays,
                      f"dist {name} rank {r}: {replays} graph replays, "
                      f"expected {want_replays}")
                w, e = weights_close(weights, alone[1])
                worst, equal = max(worst, w), equal and e
                sample_dev = max(sample_dev,
                                 float(np.abs(centres - alone[2]).max()))
            check(worst <= 1, f"dist {name}: weights at {worst:.3f} of the "
                              f"train-step bound")
            check(sample_dev < CHAIN_TOL, f"dist {name}: sample_stacked "
                                          f"differs by {sample_dev:.3e}")
            lines.append(f"{name} ({len(ranks)} rank{'s' * (len(ranks) > 1)}"
                         f", {secs:.1f} s with start-up): {alone_steps} "
                         f"steps, train steps {sorted(set(modes))}, "
                         f"{PER_STEP} a step on every "
                         f"rank, validation {PER_VAL} a batch on every "
                         f"rank, rank 0 {vals_summary(ranks[0][6])}, "
                         f"each rank's chain {want_replays} graph "
                         f"replays, weights at {worst:.4f} of the train-step "
                         f"bound (bit-equal {equal}), metrics max rel "
                         f"{rel:.3e}, files as the no-group run's, "
                         f"sample_stacked max|dx| {sample_dev:.3e} "
                         f"(tolerance {CHAIN_TOL})")
    fit_launches = {k: sum(c["launched"][k] for c in runs["gloo"][0][0][0])
                    for k in KERNELS}
    print(f"dist: {card() if dev.type == 'cuda' else where}: no process "
          f"group {alone_s:.1f} s (train steps {alone[5]}; "
          f"{vals_summary(alone[6])}), run again without a group: weights at "
          f"{again[0]:.4f} of the train-step bound (bit-equal {again[1]}); "
          + "; ".join(lines)
          + f"; rank 0 of the two gloo ranks launched {fit_launches} in "
          f"its fit", flush=True)
    return fit_launches


# -------------------------------------------------------------------- cli

REALCHEM = ROOT / "tests" / "fixtures" / "realchem"


def cli_config(tmp: Path) -> dict:
    """`train_config`'s reference-size model as a run config of the train
    CLI: one epoch over a synthetic set of 3 x 32 pockets that the CLI
    writes itself (`dataset.synthetic`, `dataset_size` 96), no sampling
    evaluation inside the epoch."""
    config = train_config(str(tmp / "data"), max_epochs=1)
    config["training"]["output_dir"] = str(tmp / "runs")
    config["training"]["evaluation"]["sample_interval"] = 0
    config["dataset"].update(synthetic=True, dataset_size=96,
                             pocket_cutoff=8)
    config["wandb"]["name"] = "cli"
    return config


@contextlib.contextmanager
def cli_counters(calls: list, k_outs: list, vals: list | None = None):
    """Inside the block, each train call's record (`record_call`) goes to
    `calls` and each validation's (`record_validation`) to `vals`, for the
    trainers a CLI builds, and each `pp_k_out` that `PocketSampler`
    probes to `k_outs`."""
    from pharmaforge_tpu_torch.training.sampling import PocketSampler
    from pharmaforge_tpu_torch.training.trainer import Trainer
    real_call, real_probe = Trainer.train_call, PocketSampler._pp_k_out
    real_validate = Trainer.validate
    vals = [] if vals is None else vals

    def call(self, batches):
        return record_call(self, lambda b: real_call(self, b), batches,
                           calls)

    def validate(self, datamodule):
        return record_validation(self, lambda d: real_validate(self, d),
                                 datamodule, vals)

    def probe(self, batch, group):
        k_outs.append(real_probe(self, batch, group))
        return k_outs[-1]

    Trainer.train_call, PocketSampler._pp_k_out = call, probe
    Trainer.validate = validate
    try:
        yield
    finally:
        Trainer.train_call, PocketSampler._pp_k_out = real_call, real_probe
        Trainer.validate = real_validate


@contextlib.contextmanager
def cli_kernel_calls(calls: dict):
    """Inside the block, the denoiser's first `knn_pf_edges` call and the
    first `fused_message_agg` call of each K2 layout (dtype, shapes,
    copies) go to `calls`, with copies of their card inputs (the message
    chain's weights as they were at the call: a fit moves them) and
    outputs, for `check_cli_kernels` to hold against the plain versions
    after the run. The capture adds no launch."""
    import copy
    from pharmaforge_tpu_torch.models import conv, edges
    real_knn, real_k2 = edges.knn_pf_edges, conv.fused_message_agg

    def keep(x):
        return x.detach().clone() if torch.is_tensor(x) else x

    def knn(*args):
        out = real_knn(*args)
        if "knn" not in calls:
            calls["knn"] = ([keep(a) for a in args], [keep(o) for o in out])
        return out

    def k2(pre_s, planes, ed, chain, **kw):
        out = real_k2(pre_s, planes, ed, chain, **kw)
        (b, p, _), (g, nd, k) = pre_s.shape, ed.mask.shape
        key = (f"{kw['compute_dtype']} B={b} P={p} G={g} Nd={nd} K={k} "
               f"copies={kw['copies']}")
        if key not in calls:
            calls[key] = ((keep(pre_s), [keep(v) for v in planes],
                           type(ed)(*(keep(t) for t in ed)),
                           copy.deepcopy(chain)), kw,
                          [keep(o) for o in out])
        return out

    edges.knn_pf_edges, conv.fused_message_agg = knn, k2
    try:
        yield
    finally:
        edges.knn_pf_edges, conv.fused_message_agg = real_knn, real_k2


def check_cli_kernels(name: str, calls: dict, layouts: int) -> dict:
    """The calls `cli_kernel_calls` kept in one chain, each held against
    its plain version on the same card tensors: K1 as `phase_knn` holds it
    (idx and mask bit-equal, geometry within KNN_GEOM_ATOL), each of the
    `layouts` K2 layouts within PP_TOL of its compute dtype. Returns the
    max abs errors."""
    from pharmaforge_tpu_torch.ops import knn_select as ks
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    calls = dict(calls)
    check("knn" in calls and len(calls) == layouts + 1,
          f"cli {name}: kept {list(calls)}, expected K1 and {layouts} K2 "
          f"layouts")
    with torch.no_grad():
        args, got = calls.pop("knn")
        errs = {"K1 pf geometry": knn_pf_compare(
            f"cli {name}", got, ks.knn_pf_edges_reference(*args))}
        for key, (args, kw, got) in calls.items():
            want = ppm.message_agg_reference(*args, **kw)
            errs[f"K2 {key}"] = compare(f"cli {name} {key}", got, want,
                                        PP_TOL[kw["compute_dtype"]])
    return errs


def chain_seconds(pocket_dir: Path) -> float:
    """A pocket's sampling time as the CLI measured it around its chain
    (the last entry of its sample_time.pkl, unrounded)."""
    with open(pocket_dir / "sample_time.pkl", "rb") as f:
        return float(pickle.load(f)[-1])


def run_cli(main, argv: list) -> tuple:
    """(return value, launch counts, wall seconds, stdout) of one CLI
    `main(argv)` in this process, every count set to 0 just before. The
    counts are the wrappers' where no chain graph replayed (a fit), else
    the chain's replayed launches, and then no launch may have been made
    beyond the chain's warm-up step and its capture (2 x a step's at
    U=1): nothing fell back to the eager loop."""
    import io
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main([str(a) for a in argv])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    counts = read_launches()
    replays = replay_counts()[0]
    if replays:
        replayed = read_replayed()
        check(all(2 * replayed[k] >= counts[k] * replays for k in counts),
              f"cli: {counts} launched outside the graphs' {replays} "
              f"replays ({replayed})")
        counts = replayed
    return out, counts, time.perf_counter() - t0, buf.getvalue()


def xyz_frames(path: Path) -> list:
    """[(element letters, coordinates [n, 3])] of each xyz frame."""
    lines, frames, i = path.read_text().splitlines(), [], 0
    while i < len(lines):
        n = int(lines[i])
        rows = [ln.split() for ln in lines[i + 1:i + 1 + n]]
        frames.append(([r[0] for r in rows],
                       np.array([r[1:] for r in rows], float)))
        i += n + 1
    return frames


def check_frames(name: str, path: Path, count: int) -> list:
    """`count` frames of 3-8 finite centres typed by the 6-type map;
    returns their sizes."""
    from pharmaforge_tpu_torch.constants import TYPE_IDX_TO_ELEM
    frames = xyz_frames(path)
    sizes = [len(e) for e, _ in frames]
    check(len(frames) == count, f"cli {name}: {len(frames)} frames in "
                                f"{path}, expected {count}")
    check(all(3 <= n <= 8 for n in sizes), f"cli {name}: sizes {sizes}")
    check(all(set(e) <= set(TYPE_IDX_TO_ELEM) and np.isfinite(x).all()
              for e, x in frames), f"cli {name}: unknown types or "
                                   f"non-finite centres in {path}")
    return sizes


def phase_cli(dev, config_fn=cli_config, samples: tuple = (8, 30)) -> dict:
    """The port's three CLIs through their `main(argv)` on the card, in a
    temporary directory, with the reference-size model:

    * train: `--config` for one epoch on the synthetic set it writes,
      `config.yaml` read back as the merged config, `metrics.jsonl` and
      `checkpoints/last/model.pt`, exactly 1 K1, 2 K2 and 2 K3 a step
      as each train call's graph replays them (`check_calls`) and 1 K1,
      2 K2 and 0 K3 a validation batch as its graph replays them
      (`check_vals`), nothing launched outside the two; then
      `--resume` with `max_epochs` 2, the step
      count going on from the first fit;
    * export: `interop.export_reference_checkpoint` writes
      `checkpoints/exported_reference.ckpt`, whose weights read back
      through `load_torch_checkpoint` bit-equal to `model.pt`;
    * test: `--model_dir` over 4 validation pockets x `samples[0]`, one
      stacked T=1000 fp32 chain: the per-pocket artifacts and
      metrics.txt, finite centres, exactly `expected_launches` K1 and K2
      for the probed `pp_k_out`, the chain's first K1 call and first call
      of each K2 layout against their plain versions;
    * generate: the aspirin receptor of tests/fixtures/realchem with its
      bound pose as the reference ligand, `--ckpt` the exported `.ckpt`
      of a copy of the run in bf16, `samples[1]` samples in one T=1000
      chain: pocket.pdb, the frames, exactly `expected_launches`, its
      kernel calls against their plain versions as in the test CLI.

    Each sampling CLI's wall is printed beside its chain time, as the CLI
    measured it into sample_time.pkl.

    * generate again with `--latency_mode on` (the step tables), the same
      checks, its chain time beside the `auto` run's.

    Returns every kernel's launches over the five CLI runs."""
    import shutil
    import tempfile
    from pharmaforge_tpu_torch.cli import generate, test, train
    from pharmaforge_tpu_torch.config.yaml_io import dump_file, load_file
    from pharmaforge_tpu_torch.interop import (
        export_reference_checkpoint, load_torch_checkpoint)
    from pharmaforge_tpu_torch.models.diffusion import DiffusionConfig
    from pharmaforge_tpu_torch.training.train_state import captured

    dev_arg = ["--device", str(dev)]
    total = dict.fromkeys(KERNELS, 0)
    lines = []
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        config = config_fn(tmp)
        dump_file(config, tmp / "cli.yml")

        calls, k_outs, vals = [], [], []
        with cli_counters(calls, k_outs, vals):
            run, fit, fit_s, _ = run_cli(
                train.main, ["--config", tmp / "cli.yml", "--seed", "1",
                             *dev_arg])
        (only,) = Path(config["training"]["output_dir"]).iterdir()
        check(only == run, f"cli train: run dir {only}, returned {run}")
        saved = load_file(run / "config.yaml")
        check(saved == dict(config, resume={"run_id": run.name[-8:]}),
              "cli train: config.yaml does not read back as the merged "
              "config")
        records = [json.loads(ln) for ln in
                   (run / "metrics.jsonl").read_text().splitlines()]
        losses = [r[k] for r in records for k in r if "loss" in k]
        check(bool(losses) and bool(np.isfinite(losses).all()),
              "cli train: non-finite or missing losses")
        check((run / "checkpoints" / "last" / "model.pt").is_file(),
              "cli train: no checkpoints/last/model.pt")
        steps = json.loads((run / "checkpoints" / "last" / "meta.json")
                           .read_text())["step"]
        check(check_calls("cli train", calls) == steps > 0,
              f"cli train: {steps} steps, {calls_summary(calls)}")
        check(fit["pp_message_bwd"]
              == sum(c["launched"]["pp_message_bwd"] for c in calls),
              f"cli train: {fit['pp_message_bwd']} K3 launches outside "
              f"the train calls' {calls_summary(calls)}")
        on_card = captured(dev)
        check_vals("cli train", vals, captured=on_card)
        check(fit == {k: sum(c["launched"][k] for c in calls + vals)
                      for k in KERNELS},
              f"cli train: wrapper counts {fit} outside the train calls and "
              f"validations")
        lines.append(f"train CLI: {steps} steps of batch "
                     f"{config['training']['batch_size']} in 1 epoch "
                     f"(dataset written by the CLI), {calls_summary(calls)}"
                     f", {vals_summary(vals)}, {fit_s} s wall, wrapper "
                     f"counts {fit} (the train and validation graphs' "
                     f"warm-ups and captures), replayed "
                     f"{read_train_replayed()} in train and "
                     f"{read_eval_replayed()[1]} in validation graphs")

        saved["training"]["trainer_args"]["max_epochs"] = 2
        dump_file(saved, run / "config.yaml")
        calls.clear()
        vals.clear()
        with cli_counters(calls, k_outs, vals):
            _, resumed, resume_s, _ = run_cli(
                train.main, ["--resume", run, *dev_arg])
        meta = json.loads((run / "checkpoints" / "last" / "meta.json")
                          .read_text())
        new = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text()
               .splitlines()][len(records):]
        check(meta["step"] == 2 * steps and meta["epoch"] == 2
              and new[0]["step"] == steps + 1,
              f"cli resume: step {meta['step']}, epoch {meta['epoch']}, "
              f"first new step {new[0]['step']} after {steps} steps")
        check(check_calls("cli resume", calls) == steps
              and check_vals("cli resume", vals, captured=on_card) > 0
              and resumed == {k: sum(c["launched"][k] for c in calls + vals)
                              for k in KERNELS},
              f"cli resume: {calls_summary(calls)}, {vals_summary(vals)}, "
              f"wrapper counts {resumed}")
        lines.append(f"train CLI --resume: steps {steps + 1}-{2 * steps} "
                     f"(epoch 2), {calls_summary(calls)}, "
                     f"{vals_summary(vals)}, {resume_s} s wall, wrapper "
                     f"counts {resumed}")

        ckpt = export_reference_checkpoint(run)
        cfg = DiffusionConfig.from_config(saved)
        got = load_torch_checkpoint(ckpt, cfg)
        want = torch.load(run / "checkpoints" / "last" / "model.pt",
                          map_location="cpu", weights_only=True)
        check(set(got) == set(want) and all(
            torch.equal(got[k], want[k]) for k in want),
            "cli export: the .ckpt weights are not bit-equal to model.pt")
        lines.append(f"export: {ckpt.name}, its {len(want)} weight tensors "
                     f"bit-equal to model.pt through load_torch_checkpoint")

        k_outs.clear()
        test_calls = {}
        with cli_counters([], k_outs), cli_kernel_calls(test_calls):
            out, sampled, test_s, stdout = run_cli(
                test.main, ["--model_dir", run, "--samples_per_pocket",
                            samples[0], "--dataset_size", 4,
                            "--max_batch_size", 4 * samples[0],
                            "--metrics", *dev_arg])
        check("stacked 4/call" in stdout and len(k_outs) == 1,
              f"cli test: not one stacked call of 4 pockets "
              f"(probes {k_outs}): {stdout[-300:]!r}")
        for name in ("metrics.txt", "metrics.pkl", "pharm_counts_None.txt",
                     "pharm_counts_None.pkl"):
            check((out / name).is_file(), f"cli test: no {name}")
        for i in range(4):
            for name in ("sample_time.txt", "sample_time.pkl"):
                check((out / f"pocket_{i}" / name).is_file(),
                      f"cli test: no pocket_{i}/{name}")
            check_frames("test", out / f"pocket_{i}" / "pharms.xyz",
                         samples[0])
        metrics = dict(ln.split(": ") for ln in
                       (out / "metrics.txt").read_text().splitlines())
        check(list(metrics)[0] == "validity" and all(
            np.isfinite(float(v)) for v in metrics.values()),
            f"cli test: metrics.txt {metrics}")
        want = expected_launches(cfg, corrected=k_outs[0] > 0)
        check(sampled == want, f"cli test: launches {sampled}, expected "
                               f"{want} (pp_k_out {k_outs[0]})")
        test_errs = check_cli_kernels(
            "test", test_calls, want["pp_message"] // cfg.n_timesteps)
        test_chain = sum(chain_seconds(out / f"pocket_{i}")
                         for i in range(4))
        lines.append(f"test CLI: 4 pockets x {samples[0]} samples, one "
                     f"stacked T={cfg.n_timesteps} chain (B={4 * samples[0]}"
                     f", fp32), pp_k_out {k_outs[0]}, {test_s} s wall = "
                     f"chain {test_chain} s (sample_time.pkl) + set-up and "
                     f"outputs {test_s - test_chain} s, launches {sampled}, "
                     f"validity {float(metrics['validity']):.3f}; first "
                     f"call of each kernel layout vs its plain version, "
                     f"max abs err {json.dumps(test_errs)}")

        bf16 = tmp / "runs" / "bf16"
        shutil.copytree(run, bf16)
        bf16_config = load_file(bf16 / "config.yaml")
        bf16_config["dynamics"]["compute_dtype"] = "bfloat16"
        dump_file(bf16_config, bf16 / "config.yaml")
        ligand = tmp / "aspirin_bound.sdf"
        # the fixture's first record is a decoy 40 A away: the bound pose
        ligand.write_text((REALCHEM / "aspirin_rec_asp_lig_tt_docked.sdf")
                          .read_text().split("$$$$\n")[1] + "$$$$\n")
        bf16_cfg = DiffusionConfig.from_config(bf16_config)
        generated = {}
        for mode in ("auto", "on"):
            k_outs.clear()
            gen_calls = {}
            with cli_counters([], k_outs), cli_kernel_calls(gen_calls):
                pocket_dir, generated[mode], gen_s, _ = run_cli(
                    generate.main, [REALCHEM / "aspirin_rec.pdb",
                                    "--ref_ligand_file", ligand, "--ckpt",
                                    bf16 / "checkpoints" /
                                    "exported_reference.ckpt",
                                    "--samples_per_pocket", samples[1],
                                    "--output_dir", tmp / f"generated_{mode}",
                                    "--latency_mode", mode, *dev_arg])
            pdb = pocket_dir / "pocket.pdb"
            check(pdb.is_file() and pdb.read_text().count("ATOM") > 0,
                  "cli generate: no pocket.pdb")
            sizes = check_frames(f"generate {mode}",
                                 pocket_dir / "pharms.xyz", samples[1])
            want = expected_launches(bf16_cfg, corrected=k_outs[0] > 0)
            check(len(k_outs) == 1 and generated[mode] == want,
                  f"cli generate {mode}: launches {generated[mode]}, "
                  f"expected {want} (pp_k_out {k_outs})")
            gen_errs = check_cli_kernels(
                f"generate {mode}", gen_calls,
                want["pp_message"] // bf16_cfg.n_timesteps)
            gen_chain = chain_seconds(pocket_dir)
            lines.append(
                f"generate CLI --latency_mode {mode}"
                f"{' (step tables)' if mode == 'on' else ''}: aspirin "
                f"pocket ({pdb.read_text().count('ATOM')} atoms), "
                f"{samples[1]} samples in one T={bf16_cfg.n_timesteps} "
                f"chain (bf16, from the exported .ckpt), pp_k_out "
                f"{k_outs[0]}, sizes {min(sizes)}-{max(sizes)}, {gen_s} s "
                f"wall = chain {gen_chain} s (sample_time.pkl) + set-up and "
                f"outputs {gen_s - gen_chain} s, launches {generated[mode]}"
                f"; first call of each kernel layout vs its plain version, "
                f"max abs err {json.dumps(gen_errs)}")
        for counts in (fit, resumed, sampled, *generated.values()):
            for k in KERNELS:
                total[k] += counts[k]
    where = card() if dev.type == "cuda" else str(dev)
    for line in lines:
        print(f"cli: {line} on {where}", flush=True)
    print(f"cli: launches over the five CLI runs {total}", flush=True)
    return total


# ------------------------------------------------------------- preprocess

# the realchem fixture's receptor pharmacophore sites as a SMARTS pass would
# find them (a copy of tests/test_realchem.py:61-73): eight within 8 A of
# the bound ligand, two beyond it
CAPTURED_SITES = {
    "NegativeIon": [[4.527, 2.617, 1.467], [7.527, 3.117, 1.967]],
    "PositiveIon": [[8.760, -2.800, 1.900]],
    "Aromatic": [[-1.940, -8.225, 1.875], [0.540, 4.650, -6.695]],
    "HydrogenDonor": [[-3.090, -0.100, 2.700], [0.160, 4.150, -9.350]],
    "HydrogenAcceptor": [[-4.080, 4.430, 1.200], [31.420, 32.430, 30.200]],
    "Hydrophobic": [[-1.940, -8.225, 1.875]],
}
PREP_LIGAND = "aspirin_rec_asp_lig_tt_docked"
# each example of the fixture: enabled pharmit points, pocket heavy atoms
# within 8 A of the bound pose, receptor sites within 8 A
PREP_COUNTS = {"pharm": 6, "prot": 54, "prot_ph": 8}
PREP_ATOL = 1e-4
# the PDB's coordinates carry 3 decimals, so a moved receptor's atoms are
# rounded by up to this much before the pipeline reads them
PDB_ROUNDING = 5e-4
# the JAX package's ImportError where Biopython is missing
# (pharmaforge_tpu/preprocessing/receptor_utils.py:157)
BIO_MISSING = "biopython is required for pocket PDB writing"
# replays the ph.json beside the receptor it is given
PHARMIT_STUB = r"""#!/bin/sh
rec=""
out=""
while [ $# -gt 0 ]; do
  case "$1" in
    -receptor) rec="$2"; shift ;;
    -out) out="$2"; shift ;;
  esac
  shift
done
cat "$(dirname "$rec")/ph.json" > "$out"
"""


def rigid_motion(rng) -> tuple:
    """(rotation [3, 3] with det +1, translation [3] within 20 A)."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q, rng.uniform(-20.0, 20.0, 3)


def moved(xyz, motion) -> np.ndarray:
    rot, shift = motion
    return np.asarray(xyz, float) @ rot.T + shift


def moved_pdb(text: str, motion) -> str:
    """A PDB with every ATOM/HETATM record's coordinates moved."""
    lines = []
    for ln in text.splitlines():
        if ln.startswith(("ATOM", "HETATM")):
            xyz = moved([float(ln[30:38]), float(ln[38:46]),
                         float(ln[46:54])], motion)
            ln = ln[:30] + "".join(f"{c:8.3f}" for c in xyz) + ln[54:]
        lines.append(ln)
    return "\n".join(lines) + "\n"


def moved_sdf(text: str, motion) -> str:
    """A V2000 SDF with the atom block of every record moved."""
    records = text.split("$$$$\n")
    for r, record in enumerate(records):
        lines = record.split("\n")
        if len(lines) < 4:
            continue
        for i in range(4, 4 + int(lines[3][:3])):
            ln = lines[i]
            xyz = moved([float(ln[0:10]), float(ln[10:20]), float(ln[20:30])],
                        motion)
            lines[i] = "".join(f"{c:10.4f}" for c in xyz) + ln[30:]
        records[r] = "\n".join(lines)
    return "$$$$\n".join(records)


def moved_pharmit(text: str, motion) -> str:
    """A pharmit document with its points (and their direction vectors)
    moved; what follows the first JSON object is kept as it was."""
    doc, end = json.JSONDecoder().raw_decode(text)
    for pt in doc["points"]:
        pt["x"], pt["y"], pt["z"] = moved([pt["x"], pt["y"], pt["z"]],
                                          motion).tolist()
        if "svector" in pt:
            sv = pt["svector"]
            sv["x"], sv["y"], sv["z"] = (motion[0] @ [sv["x"], sv["y"],
                                                      sv["z"]]).tolist()
    return json.dumps(doc, indent=1) + text[end:]


@functools.cache
def chem_stubs():
    """`tests/chem_stubs.py` (the JAX tests' RDKit SDF stand-in), loaded
    from its file as the module `chem_stubs`: another `tests` package on
    the path cannot shadow it, and the ligands it makes unpickle in this
    process."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chem_stubs", ROOT / "tests" / "chem_stubs.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chem_stubs"] = mod
    spec.loader.exec_module(mod)
    return mod


def fixture_sites(rec_path: str) -> dict:
    """The `get_mol_pharm` stand-in: the pair's moved CAPTURED_SITES,
    written beside its receptor."""
    return json.loads((Path(rec_path).parent / "sites.json").read_text())


def crossdocked_tree(root: Path, pairs: int, seed: int = 0) -> dict:
    """A CrossDocked-layout raw tree under `root` from the realchem
    fixture: per split (3) `pairs` label-1 pairs, each the fixture's
    receptor, its two-record SDF (decoy first, bound pose second), its
    ph.json and its receptor sites under one seeded rigid motion, in a
    directory of its own; each types file also has a label-0 row and a row
    whose files are missing. Returns {pair directory: motion}."""
    pdb = (REALCHEM / "aspirin_rec.pdb").read_text()
    sdf = (REALCHEM / f"{PREP_LIGAND}.sdf").read_text()
    ph = (REALCHEM / "ph.json").read_text()
    rng = np.random.default_rng(seed)
    types = root / "types"
    types.mkdir(parents=True)
    motions = {}
    for split in range(3):
        rows = []
        for i in range(pairs):
            name = f"S{split}P{i:03d}"
            motions[name] = motion = rigid_motion(rng)
            pair = root / "CrossDocked2020" / name
            pair.mkdir(parents=True)
            (pair / "aspirin_rec.pdb").write_text(moved_pdb(pdb, motion))
            with gzip.open(pair / f"{PREP_LIGAND}.sdf.gz", "wt") as f:
                f.write(moved_sdf(sdf, motion))
            (pair / "ph.json").write_text(moved_pharmit(ph, motion))
            (pair / "sites.json").write_text(json.dumps(
                {k: moved(v, motion).tolist()
                 for k, v in CAPTURED_SITES.items()}))
            rows.append(f"1 5.42 0.31276 {name}/aspirin_rec_0.gninatypes "
                        f"{name}/{PREP_LIGAND}_1.gninatypes #min_0.sdf")
        first = f"S{split}P000"
        rows.insert(1, f"0 3.10 4.88210 {first}/aspirin_rec_0.gninatypes "
                       f"{first}/{PREP_LIGAND}_0.gninatypes #min_0.sdf")
        rows.append("1 5.00 0.30000 GONE/gone_rec_0.gninatypes "
                    "GONE/gone_lig_0.gninatypes #min_0.sdf")
        (types / f"it2_tt_v1.3_0_test{split}.types").write_text(
            "\n".join(rows) + "\n")
    return motions


def fixture_example() -> dict:
    """The fixture's own example as the pipeline extracts it: pharmit
    centres, pocket heavy atoms and near receptor sites of the bound
    pose."""
    import io
    import pytest
    from pharmaforge_tpu_torch.preprocessing import crossdocked
    sdf = (REALCHEM / f"{PREP_LIGAND}.sdf").read_text()
    lig = list(chem_stubs().ForwardSDMolSupplier(io.StringIO(sdf)))[1]
    lig = lig.GetConformer().GetPositions()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(crossdocked, "get_mol_pharm", lambda _: CAPTURED_SITES)
        sites = crossdocked.receptor_sites_near_ligand(
            str(REALCHEM / "aspirin_rec.pdb"), lig, 8)[0]
    return {"pharm": crossdocked.pharmit_points(crossdocked.parse_pharmit_json(
                (REALCHEM / "ph.json").read_text()))[0],
            "prot": crossdocked.pocket_heavy_atoms_from_file(
                str(REALCHEM / "aspirin_rec.pdb"), lig, 8)[0],
            "prot_ph": sites}


def run_process_crossdocked(raw: Path, out: Path, workers: int) -> str:
    """The port's preprocessing CLI over `raw` into `out` with the
    stand-ins of the JAX package's tests: a `pharmit` on PATH, the RDKit
    SDF stand-in (`tests/chem_stubs.py`) and `fixture_sites` for
    `get_mol_pharm`; the pool's workers fork with them. Returns what the
    CLI printed."""
    import io
    import os
    import pytest
    from pharmaforge_tpu_torch.cli import process_crossdocked
    from pharmaforge_tpu_torch.config.yaml_io import dump_file
    from pharmaforge_tpu_torch.preprocessing import crossdocked
    stub_dir = raw.parent / "bin"
    stub_dir.mkdir()
    (stub_dir / "pharmit").write_text(PHARMIT_STUB)
    (stub_dir / "pharmit").chmod(0o755)
    dump_file({"dataset": {
        "raw_data_dir": str(raw), "processed_data_dir": str(out),
        "pocket_cutoff": 8, "min_pharm_centers": 3,
        "prot_elements": ["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B",
                          "D"]}}, raw.parent / "preprocess.yml")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        chem_stubs().install(mp)
        mp.setenv("PATH", f"{stub_dir}{os.pathsep}{os.environ['PATH']}")
        mp.setattr(crossdocked, "get_mol_pharm", fixture_sites)
        process_crossdocked.main(["--config", str(raw.parent /
                                                  "preprocess.yml"),
                                  "--max_workers", str(workers)])
    return buf.getvalue()


def check_processed(out: Path, raw: Path, pairs: int, motions: dict,
                    printed: str) -> float:
    """The CLI's four lines per split, each split's arrays and names, and
    the first example's coordinates against the rigid motion of the
    fixture's; returns the worst coordinate error beyond the PDB's
    rounding (pocket atoms) or in all (centres and sites)."""
    lines = [ln for ln in printed.splitlines()
             if ln.startswith(("processing types file", "failed to parse",
                               "processed ")) or " samples in " in ln]
    want = []
    for split in range(3):
        types = str(raw / "types" / f"it2_tt_v1.3_0_test{split}.types")
        want += [f"processing types file {types}",
                 f"{pairs + 1} samples in {types}",
                 "failed to parse 1 ligands and failed to obtain "
                 "pharmacophore points for 0 examples",
                 f"processed {pairs} examples"]
    check(sorted(lines) == sorted(want), f"preprocess: the CLI printed "
                                         f"{lines}, expected {want}")
    ref = fixture_example()
    worst = 0.0
    for split in range(3):
        split_dir = out / f"it2_tt_v1.3_0_test{split}"
        npz = np.load(split_dir / "prot_pharm_tensors.npz")
        for side, n in PREP_COUNTS.items():
            spans = npz[f"{side}_idx"]
            check(spans.shape == (pairs, 2) and bool(
                (spans[:, 1] - spans[:, 0] == n).all()) and len(
                npz[f"{side}_pos"]) == pairs * n,
                f"preprocess: split {split} {side} spans {spans.tolist()}, "
                f"expected {pairs} of {n}")
        with gzip.open(split_dir / "prot_file_names.pkl.gz") as f:
            names = pickle.load(f)
        check(names == [f"S{split}P{i:03d}/aspirin_rec.pdb"
                        for i in range(pairs)],
              f"preprocess: split {split} receptor names {names[:3]}...")
        if split:
            continue
        motion = motions["S0P000"]
        for side, n in PREP_COUNTS.items():
            err = float(np.abs(npz[f"{side}_pos"][:n]
                               - moved(ref[side], motion)).max())
            slack = PDB_ROUNDING if side == "prot" else 0.0
            check(err <= PREP_ATOL + slack,
                  f"preprocess: example 0 {side} coordinates {err:.3e} from "
                  f"the moved fixture's, beyond {PREP_ATOL} + {slack}")
            worst = max(worst, err - slack)
    return worst


def packer_times(ds, idx, max_pharm: int, max_prot: int,
                 calls: int) -> dict:
    """Median microseconds over `calls` calls of `pack_batch` (the batch's
    pockets), `pack_batch_gather` (up to `max_pharm` centres of each of
    its pharmacophores as a gather list) and the dataset's whole
    `pack_batch`, natively and through the numpy
    fallback (`PHARMAFORGE_NATIVE=0`), after one warm-up call each; both
    paths' outputs are checked equal."""
    import os
    from pharmaforge_tpu_torch import native
    n_el, n_ph = len(ds.prot_elements), len(ds.ph_type_map)
    rows = [np.arange(s, min(e, s + max_pharm))
            for s, e in ds.pharm_idx[idx]]
    offsets = np.cumsum([0] + [len(r) for r in rows])
    gather = np.concatenate(rows)
    fns = {"pack_batch": lambda: native.pack_batch(
               ds.prot_pos, ds.prot_feat, ds.prot_idx[idx], max_prot, n_el),
           "pack_batch_gather": lambda: native.pack_batch_gather(
               ds.pharm_pos, ds.pharm_feat, gather, offsets, max_pharm, n_ph),
           "dataset pack_batch": lambda: ds.pack_batch(idx, max_pharm,
                                                       max_prot)}
    times, outs = {}, {}
    before = os.environ.get("PHARMAFORGE_NATIVE")
    try:
        for path, flag in (("native", "1"), ("numpy", "0")):
            os.environ["PHARMAFORGE_NATIVE"] = flag
            check(native.native_available() == (path == "native"),
                  f"preprocess: the packer did not take its {path} path")
            for name, fn in fns.items():
                outs[name, path] = fn()
                walls = []
                for _ in range(calls):
                    t0 = time.perf_counter()
                    fn()
                    walls.append(time.perf_counter() - t0)
                times[f"{name} {path}"] = float(np.median(walls)) * 1e6
    finally:
        if before is None:
            os.environ.pop("PHARMAFORGE_NATIVE")
        else:
            os.environ["PHARMAFORGE_NATIVE"] = before
    for name in ("pack_batch", "pack_batch_gather"):
        check(all(np.array_equal(a, b) for a, b in
                  zip(outs[name, "native"], outs[name, "numpy"])),
              f"preprocess: native and numpy {name} differ")
    return times


def prep_config(config_fn, processed: Path, raw: Path, runs: Path) -> dict:
    """`config_fn`'s model as a run config over the processed set: one
    epoch, splits 0-1 train and 2 validates, no sampling evaluation, the
    raw receptors under `raw`/CrossDocked2020 for the test CLI."""
    config = config_fn(str(processed), max_epochs=1)
    config["training"]["output_dir"] = str(runs)
    config["training"]["evaluation"]["sample_interval"] = 0
    config["dataset"].update(raw_data_dir=str(raw / "CrossDocked2020"),
                             pocket_cutoff=8)
    config["wandb"]["name"] = "preprocessed"
    return config


def phase_preprocess(dev, pairs: int = 96, workers: int = 4,
                     config_fn=train_config, sample_steps: int = 100,
                     samples: int = 4, pack_calls: int = 50,
                     train_pack=dict(samples_per_split=64,
                                     n_prot_range=(200, 230))) -> dict:
    """CrossDocked preprocessing feeding the trainer, in a temporary
    directory. Runs before anything initialises CUDA: the CLI's pool
    forks.

    * `crossdocked_tree`: 3 splits x `pairs` moved copies of the realchem
      fixture, a label-0 row and a missing pair per split;
    * `python -m pharmaforge_tpu_torch.cli.process_crossdocked` through
      `main(argv)` with `--max_workers workers` and the JAX tests'
      stand-ins (`run_process_crossdocked`): its four lines per split,
      each example 6 centres, 54 pocket atoms and 8 sites, the first
      example's coordinates the fixture's under its motion
      (`check_processed`);
    * the C++ packer: built and taken (no numpy fallback), and its median
      times against numpy's at the train cell's batch (B=32, 192 slots,
      `phase_train`'s synthetic recipe) and at this data's (B=32, 64
      slots), beside the fit's median host wall of a step;
    * the train CLI fits `config_fn`'s model (the train cell's) for one
      epoch on the processed set on `dev`: exactly 1 K1, 2 K2 and 2 K3
      in every step (`check_calls`), 1 K1, 2 K2 and 0 K3 in every
      validation batch, each a graph replay (`check_vals`); the first K1
      call and the first K2 call of
      each layout (the train steps' and validation's) against their plain
      versions (`check_cli_kernels`) and K3 on the first train-step K2
      call's inputs against the plain version in fp64 (`ppbwd_*`);
    * the test CLI on that run at T=`sample_steps`, one pocket x
      `samples`: its frames, exactly `expected_launches`, and the JAX
      package's skip line for pocket.pdb where Biopython is missing;
    * `distance_hinge_loss` on `dev` against the CPU within 1e-6 relative.

    Returns the fit's launches."""
    import importlib.util
    import tempfile
    from pharmaforge_tpu_torch.cli import test, train
    from pharmaforge_tpu_torch.config.yaml_io import dump_file, load_file
    from pharmaforge_tpu_torch.data.dataset import ProteinPharmacophoreDataset
    from pharmaforge_tpu_torch.data.synthetic import (
        make_synthetic_processed_dataset)
    from pharmaforge_tpu_torch.losses import distance_hinge_loss
    from pharmaforge_tpu_torch.models.diffusion import DiffusionConfig
    from pharmaforge_tpu_torch.training.train_state import captured
    from pharmaforge_tpu_torch import native

    check(not torch.cuda.is_initialized(), "preprocess: CUDA is already "
                                           "initialised before the pool forks")
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        raw, processed = tmp / "raw", tmp / "processed"
        t0 = time.perf_counter()
        motions = crossdocked_tree(raw, pairs)
        tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        printed = run_process_crossdocked(raw, processed, workers)
        cli_s = time.perf_counter() - t0
        check(not torch.cuda.is_initialized(),
              "preprocess: the preprocessing CLI initialised CUDA")
        coord_err = check_processed(processed, raw, pairs, motions, printed)

        # the packer, natively and in numpy
        check(native.native_available(), "preprocess: the C++ packer did "
                                         "not build; the loader would pack "
                                         "in numpy")
        config = prep_config(config_fn, processed, raw, tmp / "runs")
        ds_keys = {k: v for k, v in config["dataset"].items()
                   if k != "processed_data_dir"}
        synth = make_synthetic_processed_dataset(
            str(tmp / "synthetic"), n_splits=1, seed=11, **train_pack)
        packs = {}
        for name, data_dir in (("train cell", synth), ("preprocessed",
                                                       processed)):
            ds = ProteinPharmacophoreDataset(
                name=name, split_idxs=[0], processed_data_dir=str(data_dir),
                graph_cutoffs={}, **ds_keys)
            batch = config["training"]["batch_size"]
            sizes = {ds.prot_size(i) for i in range(batch)}
            slots = max(64, -(-max(sizes) // 64) * 64)
            packs[f"{name} B={batch} P={slots}"] = packer_times(
                ds, np.arange(batch), int(ds.subsample_max), slots,
                pack_calls)

        # the fit on the card
        dump_file(config, tmp / "run.yml")
        train_calls, k_outs, calls, vals = [], [], {}, []
        with cli_counters(train_calls, k_outs, vals), \
                cli_kernel_calls(calls):
            run, fit, fit_s, _ = run_cli(
                train.main, ["--config", tmp / "run.yml", "--seed", "1",
                             "--device", str(dev)])
        steps = json.loads((run / "checkpoints" / "last" / "meta.json")
                           .read_text())["step"]
        want_steps = -(-2 * pairs // config["training"]["batch_size"])
        check(steps == want_steps == check_calls("preprocess fit",
                                                 train_calls),
              f"preprocess fit: {steps} steps (expected {want_steps}), "
              f"{calls_summary(train_calls)}")
        check_vals("preprocess fit", vals, captured=captured(dev))
        check(fit == {k: sum(c["launched"][k] for c in train_calls + vals)
                      for k in KERNELS},
              f"preprocess fit: wrapper counts {fit} outside the train "
              f"calls and validations")
        # two K2 layouts: the train steps' (full width) and validation's
        # (eval mode: the compact prot tail, kept from its graph's warm-up
        # forward); the first is the train step's
        errs = check_cli_kernels("preprocess fit", calls, 2)
        k2_key = next(k for k in calls if k != "knn")
        args, kw, _ = calls[k2_key]
        gen = torch.Generator(device=dev).manual_seed(5)
        b, nd = args[0].shape[0], args[2].mask.shape[1]
        cot = (torch.randn(b, nd, kw["scalar_size"], generator=gen,
                           device=dev),
               torch.randn(b, nd, kw["vector_size"], 3, generator=gen,
                           device=dev))
        errs[f"K3 {k2_key}"] = ppbwd_compare(
            "preprocess fit", ppbwd_grads(args, kw, True, cot),
            ppbwd_want(args, kw, "float32", cot), "float32")

        # the test CLI on that run
        saved = load_file(run / "config.yaml")
        saved["diffusion"]["n_timesteps"] = sample_steps
        dump_file(saved, run / "config.yaml")
        k_outs.clear()
        with cli_counters([], k_outs):
            out, sampled, test_s, stdout = run_cli(
                test.main, ["--model_dir", run, "--samples_per_pocket",
                            samples, "--dataset_size", 1, "--device",
                            str(dev)])
        check_frames("preprocess test", out / "pocket_0" / "pharms.xyz",
                     samples)
        cfg = DiffusionConfig.from_config(saved)
        want = expected_launches(cfg, corrected=bool(k_outs)
                                 and k_outs[0] > 0)
        check(sampled == want, f"preprocess test: launches {sampled}, "
                               f"expected {want} (pp_k_out {k_outs})")
        if importlib.util.find_spec("Bio") is None:
            skip = f"skipping pocket.pdb/reference files ({BIO_MISSING})"
            check(skip in stdout.splitlines(),
                  f"preprocess test: no {skip!r} line: {stdout[-400:]!r}")
            pocket_files = f"printed {skip!r}"
        else:
            check((out / "pocket_0" / "pocket.pdb").is_file(),
                  "preprocess test: no pocket.pdb")
            pocket_files = "wrote pocket.pdb and reference_files/"

    # the hinge loss on the card against the CPU
    rng = np.random.default_rng(9)
    pa = torch.as_tensor(rng.normal(scale=3.0, size=(40, 3)),
                         dtype=torch.float32)
    pb = torch.as_tensor(rng.normal(scale=3.0, size=(30, 3)),
                         dtype=torch.float32)
    hinge = []
    for other in (None, pb):
        want_h = float(distance_hinge_loss(pa, other, 2.0))
        got_h = distance_hinge_loss(
            pa.to(dev), None if other is None else other.to(dev), 2.0)
        check(got_h.device.type == dev.type, "preprocess: the hinge loss "
                                             "left its inputs' device")
        rel = abs(float(got_h) - want_h) / abs(want_h)
        check(rel <= 1e-6, f"preprocess: hinge loss {float(got_h)!r} on "
                           f"{dev} vs {want_h!r} on the CPU")
        hinge.append(rel)

    walls = [c["wall"] / c["steps"] for c in train_calls if not c["built"]]
    step_wall = float(np.median(walls)) * 1e6
    where = card() if dev.type == "cuda" else str(dev)
    print(f"preprocess: raw tree 3 x {pairs} pairs written in {tree_s:.2f} "
          f"s; process_crossdocked --max_workers {workers} {cli_s:.2f} s "
          f"(counts and shapes as expected: {PREP_COUNTS} an example; the "
          f"first example's coordinates within {coord_err:.3e} of the "
          f"moved fixture's beyond the PDB's rounding, tolerance "
          f"{PREP_ATOL}); packer native ({native.library_path().name}); "
          f"median us over {pack_calls} calls {json.dumps(packs)}; train "
          f"CLI on {where}: {steps} steps of batch "
          f"{config['training']['batch_size']} in 1 epoch, {fit_s:.2f} s "
          f"wall, {calls_summary(train_calls)}, {vals_summary(vals)}, "
          f"median host wall of a "
          f"step {step_wall:.1f} us over the calls on kept graphs, wrapper "
          f"counts {fit} (the graphs' warm-ups and captures), {PER_STEP} "
          f"a step in every call, {PER_VAL} a validation batch; first "
          f"calls vs their plain versions, "
          f"max abs err {json.dumps(errs)}; test CLI 1 pocket x {samples} "
          f"at T={sample_steps}: {test_s:.2f} s wall, launches {sampled}, "
          f"pp_k_out {k_outs}, {pocket_files}; hinge loss {dev} vs CPU "
          f"relative {hinge[0]:.2e} / {hinge[1]:.2e} (self / pairs)",
          flush=True)
    return fit


# ------------------------------------------------------------- gvp chain

# K4's cases: (chain, rows, dtype). The first eight are the rows and
# dtypes of a full-screen denoiser step (pforge-full at 4 pockets x 30, 256
# prot slots, 230 atoms): the noise head and the pharm updates (960), the
# clean prot update (1,024), the pf and fp message chains and the compact
# prot tail (4,800), the ff chains (7,680), the first conv's group-level pp
# chain (16,384) and the per-copy prot updates (30,720). The rest take the
# other dtype of each chain, and a ragged last tile.
GVP_CHAIN_CASES = {
    "noise-960": ("noise", 960, "float32"),
    "pharm-update-960": ("update", 960, "float32"),
    "clean-update-1024": ("update", 1024, "float32"),
    "pf-message-4800": ("message", 4800, "bfloat16"),
    "tail-update-4800": ("update", 4800, "float32"),
    "ff-message-7680": ("message", 7680, "bfloat16"),
    "pp-message-16384": ("message", 16384, "bfloat16"),
    "prot-update-30720": ("update", 30720, "float32"),
    "message-fp32-4800": ("message", 4800, "float32"),
    "update-bf16-7680": ("update", 7680, "bfloat16"),
    "noise-bf16-960": ("noise", 960, "bfloat16"),
    "update-ragged-1001": ("update", 1001, "float32"),
    # radius-screen's pf and fp message chains: B=60 x F=8 rows over the
    # dense P=256 prot slots, and over the M=128 radius slots
    "radius-message-122880": ("message", 122880, "bfloat16"),
    "radius-message-61440": ("message", 61440, "bfloat16"),
}
# the step's shapes, in the order above
GVP_CHAIN_STEP = tuple(GVP_CHAIN_CASES)[:8]
# the cases timed: the step's and the radius message chains
GVP_CHAIN_TIMED = GVP_CHAIN_STEP + ("radius-message-122880",
                                    "radius-message-61440")


def gvp_chain_case(dev, name: str) -> tuple:
    """Case `name`'s chain (pforge-full's widths: 128 scalars, 16
    vectors; the message chain's 3 GVPs on (scalars ++ 16 RBF, direction
    ++ vectors), the update chain's 2 square GVPs, the noise head's 4 with
    the identity-gated (64 scalars, 1 vector) last), its weights drawn
    from seed 0, and normal inputs in its dtype: (gvps, feats, vectors)."""
    from pharmaforge_tpu_torch.models.conv import message_specs
    from pharmaforge_tpu_torch.models.dynamics import NoisePredictionBlock
    from pharmaforge_tpu_torch.models.gvp import (GVPChain, gvp_specs,
                                                  reset_parameters_)
    kind, rows, dtype = GVP_CHAIN_CASES[name]
    chain = {"message": lambda: GVPChain(message_specs(3, 16, 128, 16)),
             "update": lambda: GVPChain(gvp_specs(2, 16, 128)),
             "noise": lambda: NoisePredictionBlock(128, 6, 16,
                                                   n_gvps=4).gvps}[kind]()
    gen = torch.Generator().manual_seed(0)
    reset_parameters_(chain, gen).to(dev).requires_grad_(False)
    s_in, v_in = chain[0].to_feats_out[0].weight.shape[1] \
        - chain[0].Wh.shape[1], chain[0].Wh.shape[0]
    dt = getattr(torch, dtype)
    feats = torch.randn(rows, s_in, generator=gen).to(dev, dt)
    vectors = torch.randn(rows, v_in, 3, generator=gen).to(dev, dt)
    return list(chain), feats, vectors


def gvp_chain_cost(gvps, rows: int, dtype: str) -> tuple:
    """(bytes, operations) of one K4 call: its inputs and outputs at the
    dtype's width and the fp32 weights each read once; two operations a
    multiply-add of the five products of every GVP over every row."""
    from pharmaforge_tpu_torch.ops.gvp_chain import layer_dims
    es = 2 if dtype == "bfloat16" else 4
    dims = layer_dims(gvps)
    macs = sum(3 * v_in * h + 3 * h * u + (s_in + h) * o + o * u
               for v_in, h, u, s_in, o, *_ in dims)
    n_w = sum(p.numel() for g in gvps for p in g.parameters())
    v_in, s_in = dims[0][0], dims[0][3]
    u, o = dims[-1][2], dims[-1][4]
    n_bytes = rows * es * (s_in + 3 * v_in + o + 3 * u) + 4 * n_w
    return n_bytes, 2 * macs * rows


def gvp_chain_bound_ms(gvps, rows: int, dtype: str) -> tuple:
    """(least milliseconds, "bytes" or "operations"): K4's call at 3.35
    TB/s or at the dtype's peak (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s
    fp32 FMA)."""
    n_bytes, ops = gvp_chain_cost(gvps, rows, dtype)
    by_bytes = n_bytes / PEAK_BYTES_PER_S
    by_ops = ops / (PEAK_BF16_OPS if dtype == "bfloat16" else PEAK_FP32_OPS)
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def gvp_chain_gaps(got, want) -> dict:
    """K4's outputs against the plain chain's: the largest absolute gap, and
    the largest gap in units of one rounding step of the dtype at the
    plain output (bf16: 2^-8 |want|, fp32: 2^-24 |want|, each at least
    that of 1e-3), over scalars and vectors."""
    worst, steps = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        ulp = 2.0 ** (-8 if w.dtype == torch.bfloat16 else -24)
        unit = ulp * torch.clamp(w.float().abs(), min=1e-3)
        worst = max(worst, float(d.max()))
        steps = max(steps, float((d / unit).max()))
    return {"max_abs": worst, "max_steps": steps}


# K4 against its plain twin in the chain's dtype. fp32: the same sums in
# another order (FMA, k in turn, against cuBLAS's fp32 GEMM with TF32 off)
# through 2-4 GVPs: a few fp32 rounding steps. bf16: both round every
# stored tensor to bf16, and the tensor cores sum in another order than
# cuBLAS's, so an output can sit on the other side of a bf16 rounding
# midpoint, and that step passes on through the chain's later GVPs.
GVP_CHAIN_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
                 "bfloat16": dict(rtol=2 ** -6, atol=2 ** -8)}


@contextlib.contextmanager
def plain_gvp_chains():
    """Inside the block every GVP chain runs the plain chain on the card
    too (`models/gvp.py::run_gvps` finds `gvp_chain_reference` where it
    calls `fused_gvp_chain`): the path before K4, for comparison. A graph
    captured inside keeps it; use a fresh model."""
    from pharmaforge_tpu_torch.models import gvp
    real = gvp.fused_gvp_chain
    gvp.fused_gvp_chain = gvp.gvp_chain_reference
    try:
        yield
    finally:
        gvp.fused_gvp_chain = real


def gvp_chain_run(dev, name: str) -> dict:
    """Case `name` on the card: K4 against the plain chain (gaps and the
    tolerance's excess, 1 at its edge), two launches bit-equal, one
    captured in a CUDA graph bit-equal to eager, the launch counted."""
    from pharmaforge_tpu_torch.ops.gvp_chain import (fused_gvp_chain,
                                                     gvp_chain_reference)
    from pharmaforge_tpu_torch.utils import trace
    gvps, feats, vectors = gvp_chain_case(dev, name)
    dtype = GVP_CHAIN_CASES[name][2]
    with torch.no_grad():
        before = trace.counters()["gvp_chain.launches"]
        got = fused_gvp_chain(gvps, feats, vectors)
        again = fused_gvp_chain(gvps, feats, vectors)
        torch.cuda.synchronize()
        launched = trace.counters()["gvp_chain.launches"] - before
        want = gvp_chain_reference(gvps, feats, vectors)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fused_gvp_chain(gvps, feats, vectors)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            captured = fused_gvp_chain(gvps, feats, vectors)
        graph.replay()
        torch.cuda.synchronize()
    tol = GVP_CHAIN_TOL[dtype]
    over = max(float(((g.float() - w.float()).abs()
                      / (tol["atol"] + tol["rtol"] * w.float().abs())).max())
               for g, w in zip(got, want))
    return {"name": name, "dtype": dtype, **gvp_chain_gaps(got, want),
            "tol_units": over, "launches": launched,
            "repeat_equal": all(torch.equal(a, b) for a, b in zip(got, again)),
            "graph_equal": all(torch.equal(a, b)
                               for a, b in zip(got, captured)),
            "shapes": [tuple(t.shape) for t in got]}


def gvp_chain_times(dev, name: str) -> dict:
    """Case `name`'s milliseconds a call, K4 and the plain chain, each from
    a CUDA-graph replay, beside K4's bound."""
    from pharmaforge_tpu_torch.ops.gvp_chain import (fused_gvp_chain,
                                                     gvp_chain_reference)
    gvps, feats, vectors = gvp_chain_case(dev, name)
    _, rows, dtype = GVP_CHAIN_CASES[name]
    with torch.no_grad():
        k4 = graph_ms(lambda: fused_gvp_chain(gvps, feats, vectors))
        plain = graph_ms(lambda: gvp_chain_reference(gvps, feats, vectors))
    bound, by = gvp_chain_bound_ms(gvps, rows, dtype)
    return {"ms": k4, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "roofline": bound / k4, "library": "none"}


def fullscale_gvp_gaps(dev) -> dict:
    """One full-screen call's chain (pforge-full: `full_config`, bf16 edge
    chains, the correction at the probed k_out; 4 pockets x 30 rows of
    230-atom pockets, injected noise from seed 3) with K4 and
    with the plain chains (`plain_gvp_chains`), each on a fresh model of
    the same weights: the benchmark's comparison numbers between the two
    (`x_gap_median`: the median over rows of each row's widest coordinate
    gap over its valid centres; `h_gap`: the widest feature gap; `x_gap`:
    the widest coordinate gap), and the K4 chain's counts: launches
    captured (the wrappers' count) and replayed, graph replays."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    from pharmaforge_tpu_torch.utils import trace
    cfg, per_pocket, atoms = full_config(), 30, 230
    sizes = np.random.default_rng(0).integers(3, 9, per_pocket)
    pk = synthetic_pockets(4, atoms)
    batch = stacked_batch(pk, sizes, atoms)

    def model():
        return PharmacophoreDiffusion(
            cfg, device=dev, generator=torch.Generator().manual_seed(0))

    k4 = model()
    kw = dict(noise=chain_noise(batch.batch_size, cfg.n_timesteps, seed=3),
              pocket_group_size=per_pocket,
              pp_k_out=stacked_k_out(k4, pk, atoms))
    reset_launches()
    got = k4.sample_given_receptor(batch, **kw)
    torch.cuda.synchronize()
    counts = trace.counters()
    plain = model()
    with plain_gvp_chains():
        want = plain.sample_given_receptor(batch, **kw)
        torch.cuda.synchronize()
    m = got["pharm_mask"]
    dx = ((got["pharm_x"] - want["pharm_x"]).abs().amax(-1) * m).amax(-1)
    dh = (got["pharm_h"] - want["pharm_h"]).abs().amax(-1) * m
    return {"x_gap_median": float(dx.median()), "h_gap": float(dh.max()),
            "x_gap": float(dx.max()), "rows": int(m.shape[0]),
            "captured": counts["gvp_chain.launches"],
            "replayed": counts["chain.replayed.gvp_chain"],
            "replays": counts["chain.replays"], "steps": cfg.n_timesteps}


# the benchmark's limits of full-screen's comparison (PERF.md section 2)
FULLSCREEN_LIMITS = {"x_gap_median": 2.5e-05, "h_gap": 1.2e-04}
# K4 launches a full-scale denoiser call: 12 message chains, 8 update
# chains, the noise head
GVP_CHAINS_PER_STEP = 21


def phase_gvpchain(dev) -> dict:
    """K4 (`ops/gvp_chain.py`) on the card: every case of GVP_CHAIN_CASES
    against the plain chain in its dtype within GVP_CHAIN_TOL, two
    launches bit-equal, a captured graph bit-equal to eager; the step's
    shapes timed (K4 and the plain chain from graph replays, beside K4's
    bound; no library call computes a GVP chain); a full-screen chain
    with K4 against the plain chains within the benchmark's limits, 21 K4
    launches a step replayed. Returns the kernels-line entry."""
    lines = []
    for name in GVP_CHAIN_CASES:
        r = gvp_chain_run(dev, name)
        check(r["launches"] == 2, f"gvpchain {name}: {r['launches']} "
                                  f"launches counted for 2 calls")
        check(r["repeat_equal"], f"gvpchain {name}: repeats differ")
        check(r["graph_equal"], f"gvpchain {name}: the captured call "
                                f"differs from eager")
        line = (f"{name} {r['dtype']} {r['shapes']}: max abs "
                f"{r['max_abs']:.3e}, {r['max_steps']:.2f} rounding steps, "
                f"{r['tol_units']:.3f} of the tolerance")
        if name in GVP_CHAIN_TIMED:
            t = gvp_chain_times(dev, name)
            line += (f"; {t['ms'] * 1e3:.2f} us a call (plain "
                     f"{t['plain_ms'] * 1e3:.2f} us; bound "
                     f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, "
                     f"{100 * t['roofline']:.2f}%); library call: none")
        print(f"gvpchain: {line}", flush=True)
        lines.append(line)
        check(r["tol_units"] <= 1.0, f"gvpchain {name}: beyond the "
                                     f"tolerance ({r['tol_units']:.3f})")
    g = fullscale_gvp_gaps(dev)
    print(f"gvpchain: full-screen chain, K4 against the plain chains over "
          f"{g['rows']} rows at T={g['steps']}: x_gap_median "
          f"{g['x_gap_median']:.3e} (limit "
          f"{FULLSCREEN_LIMITS['x_gap_median']}), h_gap {g['h_gap']:.3e} "
          f"(limit {FULLSCREEN_LIMITS['h_gap']}), x_gap {g['x_gap']:.3e}; "
          f"K4 launches {g['captured']} counted by the wrapper, "
          f"{g['replayed']} replayed in {g['replays']} replays", flush=True)
    for key, limit in FULLSCREEN_LIMITS.items():
        check(g[key] <= limit, f"gvpchain: full-screen {key} {g[key]:.3e} "
                               f"above {limit}")
    check(g["replayed"] == GVP_CHAINS_PER_STEP * g["steps"],
          f"gvpchain: {g['replayed']} K4 launches replayed, expected "
          f"{GVP_CHAINS_PER_STEP} x {g['steps']}")
    return {"name": "gvp_chain", "cases": lines, "fullscreen": g}


def timed(phase, *args, **kw):
    """`phase(*args, **kw)`, its wall seconds printed after it."""
    t0 = time.perf_counter()
    out = phase(*args, **kw)
    print(f"wall: {phase.__name__} {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


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
    # first: its preprocessing pool forks, before CUDA is initialised
    prep_launches = timed(phase_preprocess, dev)
    knn = timed(phase_knn, dev)
    timed(phase_golden, dev)
    timed(phase_graphs, dev, profile=profile)
    dev_launches = timed(phase_main, dev, profile)
    pp = timed(phase_pp, dev)
    gvp = timed(phase_gvpchain, dev)
    per_step: dict = {}
    full_launches = timed(phase_fullscale, dev, profile, keep=per_step)
    width_launches = timed(phase_fullwidth, dev, profile)
    tables_launches = timed(phase_tables, dev, per_step=per_step)
    ppbwd = timed(phase_ppbwd, dev)
    timed(phase_trainstep, dev, profile)
    timed(phase_evalstep, dev)
    train_launches, train_replayed, train_graphs, (val_replays, val_graphs) \
        = timed(phase_train, dev, profile)
    dist_launches = timed(phase_dist, dev)
    cli_launches = timed(phase_cli, dev)
    timed(phase_bench, dev)
    kernels = [knn, pp, ppbwd]
    for kern in kernels:
        # `launches`: the 2-epoch training run, as the wrappers count
        # (its train and validation graphs' warm-ups and captures, its
        # sampling chain's capture)
        kern["launches"] = train_launches[kern["name"]]
        # the launches below: each graph's captured launches x its
        # replays (the registry's `train.replayed.<kernel>` for the fit's
        # train graphs, `eval.replayed.<kernel>` for its validation
        # graphs, `chain.replayed.<kernel>` for the chains)
        kern["launches_train_replayed_fit"] = train_graphs[kern["name"]]
        kern["launches_eval_replayed_fit"] = val_graphs[kern["name"]]
        kern["eval_graph_replays_fit"] = val_replays
        kern["launches_replayed_fit"] = train_replayed[kern["name"]]
        kern["graph_replays_fullscale_chain"] = chain_replays(full_config())
        kern["graph_replays_dev_chain"] = chain_replays(dev_config())
        kern["launches_fullscale_chain"] = full_launches[kern["name"]]
        kern["launches_fullwidth_chain_t100"] = width_launches[kern["name"]]
        kern["launches_dev_chain"] = dev_launches[kern["name"]]
        kern["launches_cli"] = cli_launches[kern["name"]]
        kern["launches_tables_chain"] = tables_launches[kern["name"]]
        kern["launches_dist_rank0"] = dist_launches[kern["name"]]
        kern["launches_preprocessed_fit"] = prep_launches[kern["name"]]
        for key in ("launches", "launches_train_replayed_fit",
                    "launches_preprocessed_fit"):
            check(kern[key] > 0, f"{kern['name']}: not launched in "
                                 f"{key}")
    print(card())
    print(json.dumps({"kernels": kernels + [gvp]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
