#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`pharmaforge_tpu_torch`).

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # also traces one chain with torch.profiler

Phases, one line each; any failure raises and the script exits non-zero:

1. build   -- compile every CUDA kernel of the sampling path from
              `pharmaforge_tpu_torch/csrc` (nvcc, sm_90a);
2. knn     -- the `knn_select` kernel against its plain PyTorch version on
              the card: idx, dist and xg bit-equal at the sampling shape
              and at edge cases (ties, a masked pharm row, fewer valid
              atoms than k, an odd batch, k in {1, 5, 8}); device times
              (CUDA-graph replay between CUDA events) of the kernel, the
              plain version and `torch.topk`;
3. golden  -- the frozen chains `tests/golden/trajectory_{radius,knn}.npz`
              on the card within 2e-3, the knn chain through the kernel
              exactly T times;
4. main    -- the dev model at full width (n_convs=2, 128 scalars, 16
              vectors, T=100, fp32, random weights from a seed) sampling 8
              synthetic 230-atom pockets x 30 samples through
              `PocketSampler.sample_stacked` (B=240): finite output, zero
              padded slots, exactly 100 kernel launches per chain,
              samples/s; and 1 pocket x 8 samples on the CPU and the card
              with the same injected noise, within 2e-3.

Then the card's name and power limit, the `kernels` JSON line, and the
final `{"ok": true, ...}` line. Without CUDA it exits 1 and prints no
result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHAIN_TOL = 2e-3          # the JAX package's full-chain tolerance
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS = 67e12


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

def phase_build() -> None:
    from pharmaforge_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.build("knn_select")
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "smem" in ln]
    print(f"build: knn_select.cu -> {lib.name} in {secs:.2f} s; "
          f"{' | '.join(ptxas)}", flush=True)


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
    """pharm centres near synthetic pocket atoms, with sizes 3..f."""
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


def phase_knn(dev) -> dict:
    from pharmaforge_tpu_torch.ops import knn_select as ks
    rng = np.random.default_rng(0)
    cases = []
    bench = knn_case(rng, 240)
    cases.append(("bench B=240 k=5", bench, 5))
    px, pm, qx, qm = (a.copy() for a in knn_case(rng, 4))
    qx[0, 7] = qx[0, 3]               # exact duplicate coordinates: ties
    qx[1, 10] = qx[1, 2]
    pm[1, :] = False                  # a masked-out pharm row
    qm[2, 3:] = False                 # fewer valid atoms than k
    for k in (1, 5, 8):
        cases.append((f"edge B=4 k={k}", (px, pm, qx, qm), k))
    cases.append(("odd B=3 k=5", knn_case(rng, 3), 5))

    max_err = 0.0
    for name, arrs, k in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrs]
        got = ks.knn_select(*args, k)
        want = ks.knn_select_reference(*args, k)
        torch.cuda.synchronize()
        for label, g, w in zip(("idx", "dist", "xg"), got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"knn {name}: {label} {g.dtype}{tuple(g.shape)} vs "
                  f"{w.dtype}{tuple(w.shape)}")
            check(torch.equal(g, w), f"knn {name}: {label} differs from "
                                     f"the plain version")
        max_err = max(max_err, float((got[1] - want[1]).abs().max()),
                      float((got[2] - want[2]).abs().max()))

    args = [torch.from_numpy(a).to(dev) for a in bench]
    b, f = bench[1].shape
    p, k = bench[3].shape[1], 5
    eager_ms = cuda_ms(lambda: ks.knn_select(*args, k))
    kernel_ms = graph_ms(lambda: ks.knn_select(*args, k))
    plain_ms = graph_ms(lambda: ks.knn_select_reference(*args, k))
    d2 = torch.cdist(args[0], args[2]) ** 2
    library_ms = graph_ms(lambda: torch.topk(d2, k, largest=False))
    # least time for the same work: inputs read once, outputs written once
    n_bytes = b * f * 13 + b * p * 13 + b * f * k * 20
    n_ops = b * f * p * (8 + k)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_OPS
    print(f"knn: {len(cases)} cases bit-equal to the plain version "
          f"(max_abs_err {max_err}); B={b} F={f} P={p} k={k}, per call "
          f"from CUDA-graph replay: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.topk on precomputed d2 "
          f"{library_ms:.4f} ms; bound {max(t_bytes, t_ops) * 1e3:.6f} ms "
          f"({n_bytes} B, {n_ops} ops); kernel called eagerly back to "
          f"back {eager_ms:.4f} ms (host dispatch)", flush=True)
    return {"name": "knn_select", "route": "cuda",
            "source": "pharmaforge_tpu_torch/csrc/knn_select.cu",
            "replaces": "pharmaforge_tpu/ops/pallas/knn_select.py:182",
            "max_abs_err": max_err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
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


def phase_main(dev, profile: bool = False, n_pockets: int = 8,
               per_pocket: int = 30, atoms: int = 230, cfg=None) -> int:
    from pharmaforge_tpu_torch.data.batch import tile_pocket
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    from pharmaforge_tpu_torch.ops import knn_select as ks
    from pharmaforge_tpu_torch.training.sampling import PocketSampler

    cfg = cfg or dev_config()
    model = PharmacophoreDiffusion(
        cfg, device=dev, generator=torch.Generator().manual_seed(0))
    pockets = synthetic_pockets(n_pockets, atoms)
    sizes = np.random.default_rng(0).integers(3, 9, per_pocket)
    n_pharms = [sizes] * n_pockets
    sampler = PocketSampler(model, fixed_prot_slots=atoms, device=dev)
    gen = torch.Generator(device=dev)

    gen.manual_seed(1)
    sampler.sample_stacked(pockets, n_pharms, gen)   # warm-up
    torch.cuda.synchronize()
    rates, launches = [], None
    for rep in range(3):
        gen.manual_seed(2 + rep)
        ks.launches = 0
        t0 = time.perf_counter()
        res = sampler.sample_stacked(pockets, n_pharms, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if launches is None:
            launches = ks.launches
        check(ks.launches == cfg.n_timesteps,
              f"main: {ks.launches} knn_select launches in a chain, "
              f"expected {cfg.n_timesteps}")
        rates.append(n_pockets * per_pocket / dt)
    out = sampler.last_output
    mask = out["pharm_mask"]
    check(out["pharm_x"].shape == (n_pockets * per_pocket, 8, 3),
          f"main: pharm_x shape {out['pharm_x'].shape}")
    check(all(np.isfinite(out[k]).all() for k in ("pharm_x", "pharm_h")),
          "main: non-finite output")
    check(not out["pharm_x"][~mask].any() and not out["pharm_h"][~mask].any(),
          "main: padded pharm slots are not zero")
    check(len(res) == n_pockets and all(
        [r.n_ph_centers for r in rs] == list(sizes) for rs in res),
        "main: sample sizes differ from the request")

    # the same model and injected noise on the CPU and on the card
    batch = tile_pocket(pockets[0]["prot_x"], pockets[0]["prot_h"],
                        sizes[:8], max_prot=atoms)
    rng = np.random.default_rng(3)
    b, t = batch.batch_size, cfg.n_timesteps
    noise = {"x_T": rng.normal(size=(b, 8, 3)),
             "h_T": rng.normal(size=(b, 8, 6)),
             "pos": rng.normal(size=(t, b, 8, 3)),
             "feat": rng.normal(size=(t, b, 8, 6))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    on_card = model.sample_given_receptor(batch, noise=noise,
                                          pocket_group_size=b)
    on_cpu = copy.deepcopy(model).to("cpu").sample_given_receptor(
        batch, noise=noise, pocket_group_size=b)
    cpu_dev = float((on_card["pharm_x"].cpu() - on_cpu["pharm_x"])
                    .abs().max())
    check(cpu_dev < CHAIN_TOL, f"main: card vs CPU final coords differ by "
                               f"{cpu_dev:.3e} >= {CHAIN_TOL}")
    print(f"main: dev model B={n_pockets * per_pocket} T={t} on "
          f"{card()}: samples/s {' '.join(f'{r:.1f}' for r in rates)}; "
          f"{launches} knn_select launches per chain; card vs CPU "
          f"max|dx| {cpu_dev:.3e} (tolerance {CHAIN_TOL})", flush=True)

    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof
        gen.manual_seed(9)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            sampler.sample_stacked(pockets, n_pharms, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

        def self_us(e):
            return (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0))

        # device-side events only (kernels, copies): the host ops that
        # launch them report the same time again
        events = [e for e in p.key_averages()
                  if e.device_type == DeviceType.CUDA and self_us(e) > 0]
        busy = sum(self_us(e) for e in events) / 1e6
        top = sorted(events, key=lambda e: -self_us(e))[:12]
        knn = [e for e in events if "knn_select_kernel" in e.key]
        knn_us = (sum(self_us(e) for e in knn)
                  / max(sum(e.count for e in knn), 1))
        print(f"profile: chain wall {wall:.4f} s under the profiler, "
              f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%) in "
              f"{sum(e.count for e in events)} device kernels and copies; "
              f"knn_select_kernel {knn_us:.2f} us per launch on the device; "
              + "; ".join(f"{e.key[:40]} {self_us(e) / 1e3:.2f}"
                          f" ms x{e.count}" for e in top), flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    phase_build()
    kernel = phase_knn(dev)
    phase_golden(dev)
    kernel["launches"] = phase_main(dev, profile)
    print(card())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
