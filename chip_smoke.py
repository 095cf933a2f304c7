#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`pharmaforge_tpu_torch`).

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # also traces chains and a train step
                                     # with torch.profiler

Phases, one line each; any failure raises and the script exits non-zero:

1. build     -- compile every CUDA kernel of the sampling and training
                paths from `pharmaforge_tpu_torch/csrc` (nvcc, sm_90a; one
                nvcc per source, all started together);
2. knn       -- the `knn_select` kernel (K1) against its plain PyTorch
                version on the card: idx, dist and xg bit-equal at the
                sampling shape and at edge cases (ties, a masked pharm
                row, fewer valid atoms than k, an odd batch, k in
                {1, 5, 8}); device times (CUDA-graph replay between CUDA
                events) of the kernel, the plain version and `torch.topk`;
3. golden    -- the frozen chains `tests/golden/trajectory_{radius,knn}.npz`
                on the card within 2e-3, the knn chain through K1 exactly T
                times;
4. main      -- the dev model at full width (n_convs=2, 128 scalars, 16
                vectors, T=100, fp32, random weights from a seed) sampling
                8 synthetic 230-atom pockets x 30 samples through
                `PocketSampler.sample_stacked` (B=240): finite output, zero
                padded slots, exactly 100 K1 and no K2 launches per chain,
                samples/s; and 1 pocket x 8 samples on the CPU and the card
                with the same injected noise, within 2e-3;
5. pp        -- the fused pp-message kernel (K2) against its plain version
                on the card, in bf16 and fp32: the sampling shape (B=120 =
                4 pockets x 30 copies, P=Nd=230, K=16, S=128, V=16, 3
                GVPs), the compact tail (copies=1, Nd=40), the training
                batch (B=32, P=Nd=192 and 256), and edge cases (hidden
                width V+1, a fully masked destination, K=1, an odd batch,
                every slot an edge, Nd=233, K=64, widths 72/8/9, 5 GVPs),
                two calls bit-equal; device times (graph replay) of the
                wrapper call and of the kernel alone in bf16 and fp32 at
                the sampling shape and in fp32 at the training shape, each
                beside its bound, of the plain version, and the eager time;
6. fullscale -- the reference-size model (n_convs=4, T=1000, endpoint,
                bf16 edge chains, same widths, random weights from a seed)
                sampling 4 synthetic 230-atom pockets x 30 through
                `PocketSampler.sample_stacked` (B=120): finite zero-padded
                output, exactly 2,000 K2 and 1,000 K1 launches per chain,
                samples/s over timed chains after a warm-up; and the same
                model in fp32 over 20 steps, 1 pocket x 8, on the card and
                on the CPU with the same injected noise, within 2e-3;
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

import copy
import dataclasses
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
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) op/s,
# dense bf16 tensor-core op/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS = 67e12
PEAK_BF16_OPS = 989e12
KERNELS = ("knn_select", "pp_message", "pp_message_bwd")


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
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_build.build, KERNELS))
    secs = time.perf_counter() - t0
    for name, lib in zip(KERNELS, libs):
        ptxas = [ln.strip() for ln in
                 lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln]
        print(f"build: {name}.cu -> {lib.name}; {' | '.join(ptxas)}",
              flush=True)
    print(f"build: {len(KERNELS)} kernels in {secs:.2f} s", flush=True)


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


def full_config():
    """The reference-size model of bench.py's full-scale workload
    (bench.py:229-239, 535): the dev widths at n_convs=4 and T=1000, with
    the endpoint parameterization and bf16 edge-message chains."""
    return dataclasses.replace(dev_config(), n_timesteps=1000, n_convs=4,
                               precision=1e-4, endpoint_param_feat=True,
                               endpoint_param_coord=True,
                               compute_dtype="bfloat16")


def kernel_counters():
    """Kernel name -> (module, name of its wrapper's launch count)."""
    from pharmaforge_tpu_torch.ops import knn_select, pp_message
    return {"knn_select": (knn_select, "launches"),
            "pp_message": (pp_message, "launches"),
            "pp_message_bwd": (pp_message, "bwd_launches")}


def reset_launches() -> None:
    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in kernel_counters().items()}


def expected_launches(cfg) -> dict:
    """One chain of `cfg`: K1 once per denoiser call (knn pf), K2 once per
    middle conv (convs 1 .. n-2) per call."""
    t = cfg.n_timesteps
    return {"knn_select": t if cfg.pf_k else 0,
            "pp_message": t * max(cfg.n_convs - 2, 0) if cfg.fused_pp else 0,
            "pp_message_bwd": 0}


def phase_sampling(name: str, dev, cfg, n_pockets: int, per_pocket: int,
                   atoms: int, timed: int, cmp_steps: int,
                   profile: bool = False) -> dict:
    """Drive `cfg` through `PocketSampler.sample_stacked`: a warm-up chain,
    then `timed` chains with every launch count set to 0 just before and
    read just after; then the same weights in fp32 over `cmp_steps` steps,
    1 pocket x 8, on the card and on the CPU with the same injected noise.
    Returns the launch counts of one timed chain."""
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

    want = expected_launches(cfg)
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

    # the same weights in fp32 and injected noise on the CPU and the card
    cmp_cfg = dataclasses.replace(cfg, n_timesteps=cmp_steps,
                                  compute_dtype="float32")
    cmp_model = PharmacophoreDiffusion(cmp_cfg, device=dev)
    cmp_model.load_state_dict(model.state_dict())
    batch = tile_pocket(pockets[0]["prot_x"], pockets[0]["prot_h"],
                        sizes[:8], max_prot=atoms)
    rng = np.random.default_rng(3)
    b = batch.batch_size
    noise = {"x_T": rng.normal(size=(b, 8, 3)),
             "h_T": rng.normal(size=(b, 8, 6)),
             "pos": rng.normal(size=(cmp_steps, b, 8, 3)),
             "feat": rng.normal(size=(cmp_steps, b, 8, 6))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    reset_launches()
    on_card = cmp_model.sample_given_receptor(batch, noise=noise,
                                              pocket_group_size=b)
    torch.cuda.synchronize()
    cmp_launches = read_launches()
    check(cmp_launches == expected_launches(cmp_cfg),
          f"{name}: card-vs-CPU chain launches {cmp_launches}")
    on_cpu = copy.deepcopy(cmp_model).to("cpu").sample_given_receptor(
        batch, noise=noise, pocket_group_size=b)
    cpu_dev = float((on_card["pharm_x"].cpu() - on_cpu["pharm_x"])
                    .abs().max())
    check(cpu_dev < CHAIN_TOL, f"{name}: card vs CPU final coords differ "
                               f"by {cpu_dev:.3e} >= {CHAIN_TOL}")
    print(f"{name}: B={n_pockets * per_pocket} T={cfg.n_timesteps} "
          f"n_convs={cfg.n_convs} {cfg.compute_dtype} on {card()}: "
          f"samples/s {' '.join(f'{r:.2f}' for r in rates)}; launches per "
          f"chain {launches}; card vs CPU (fp32, T={cmp_steps}, B={b}) "
          f"max|dx| {cpu_dev:.3e} (tolerance {CHAIN_TOL})", flush=True)

    if profile:
        prof_steps = min(cfg.n_timesteps, 100)
        prof_model = PharmacophoreDiffusion(
            dataclasses.replace(cfg, n_timesteps=prof_steps), device=dev)
        prof_model.load_state_dict(model.state_dict())
        profile_chain(name, PocketSampler(prof_model, fixed_prot_slots=atoms,
                                          device=dev),
                      pockets, n_pharms, gen, prof_steps)
    return launches


def profile_chain(name: str, sampler, pockets, n_pharms, gen,
                  steps: int) -> None:
    """One chain under torch.profiler: device busy share and the kernels
    that take the most device time."""
    gen.manual_seed(9)
    sampler.sample_stacked(pockets, n_pharms, gen)      # warm-up
    torch.cuda.synchronize()
    profile_run(f"profile {name}: chain of T={steps}",
                lambda: sampler.sample_stacked(pockets, n_pharms, gen))


def profile_run(label: str, fn) -> None:
    """`fn` once under torch.profiler; prints its wall time, the device's
    busy share, each port kernel's time per launch and the 12 kernels that
    take the most device time."""
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
            cutoff: float = 3.5, n_gvps: int = 3):
    """One K2 call as the main path makes it: the pp edges of synthetic
    pockets at pocket-group level, random node tables in the compute
    dtype (or `table_dtype`), a message chain with seeded weights. `nd`
    picks that many destination atoms per row (the compact-tail call, one
    row per group); `slots` pads the pockets' `atoms` to that many slots
    (the training batch); `dup` makes one source atom occur twice in one
    destination's list and in a list of another tile. `cutoff` is the pp
    radius (3.5 A on the main path; a large one makes every slot of an
    atom with K neighbours an edge); `n_gvps` the message chain's depth."""
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
    edge = GroupedEdgeData(*ed, copies=copies) if copies > 1 else ed
    specs = message_specs(n_gvps, v, s, 16)
    specs[1:] = [dict(sp, hidden_vectors=hj) for sp in specs[1:]]
    chain = reset_parameters_(GVPChain(specs),
                              torch.Generator().manual_seed(7)).to(dev)
    b = n_groups * copies
    tdt = table_dtype or dt
    pre_s = torch.randn(b, slots, s, generator=gen, device=dev).to(tdt)
    planes = [(0.5 * torch.randn(b, slots, v + 1, generator=gen,
                                 device=dev)).to(tdt) for _ in range(3)]
    kw = dict(scalar_size=s, vector_size=v, rbf_dim=16,
              compute_dtype=dtype, copies=copies)
    return (pre_s, planes, edge, chain), kw


def pp_bound(args, kw) -> tuple:
    """(bytes, operations, edge rows) of one K2 call: the kernel's inputs
    read once (tables, group-level idx/mask/rterm/dirterm, packed weights)
    and its fp32 outputs written once; two operations per multiply-add of
    the chain over the edge rows whose mask is set."""
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    pre_s, planes, edge, chain = args
    s, v, copies = kw["scalar_size"], kw["vector_size"], kw["copies"]
    b, p, _ = pre_s.shape
    g, nd, k = edge.mask.shape
    h0 = planes[0].shape[-1]
    w = ppm.split_weights(chain, s, kw["rbf_dim"])
    hj = w[7].shape[1]
    n_j = (len(w) - 7) // 7
    elem = pre_s.element_size()
    packed = sum(a.numel() for i, a in enumerate(w) if i not in (0, 2, 4))
    n_bytes = (elem * (b * p * s + b * p * 3 * h0 + g * nd * k * (s + 3 * h0)
                       + packed)
               + 8 * g * nd * k + 4 * b * nd * (s + 3 * v))
    macs = (h0 * s + s * v + 3 * h0 * v
            + n_j * (3 * v * hj + s * s + hj * s + s * v + 3 * hj * v))
    rows = int(edge.mask.sum()) * copies
    return n_bytes, 2 * macs * rows, rows


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
# two calls on the same inputs give bit-equal sums (no atomics)
PP_REPEAT = ("main", "train B=32 P=Nd=192", "train B=32 P=Nd=256", "dense",
             "K=64")
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
          f"to back {eager_ms:.4f} ms", flush=True)
    return {"name": "pp_message", "route": "cuda",
            "source": "pharmaforge_tpu_torch/csrc/pp_message.cu",
            "replaces": "pharmaforge_tpu/ops/pallas/pp_message.py:386",
            "max_abs_err": errs["main bfloat16"], "ms": bf[0],
            "kernel_ms": bf[0], "kernel_alone_ms": bf[6],
            "earlier_ms": PP_EARLIER_MS,
            "fp32_ms": f32[0], "fp32_kernel_alone_ms": f32[6],
            "fp32_bound_ms": f32[1], "fp32_bound_by": f32[2],
            "train_fp32_ms": train[0], "train_fp32_kernel_alone_ms": train[6],
            "train_fp32_bound_ms": train[1], "train_fp32_bound_by": train[2],
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bf[1], "bound_by": bf[2], "library_ms": None}


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
    """(bytes, operations, edge rows) of one K3 call: its inputs read once
    (K2's inputs, the raw geometry, the fp32 cotangents) and its outputs
    written once (fp32 node tables, fp64 weight gradients); two operations
    per multiply-add of the chain's
    recompute and backward over the edge rows whose mask is set."""
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
    packed = sum(a.numel() for i, a in enumerate(w) if i not in (0, 2, 4))
    grads = sum(a.numel() for a in w)
    n_bytes = (elem * (b * p * (s + 3 * h0)
                       + g * nd * k * (s + 3 * h0 + r + 3) + packed)
               + 8 * g * nd * k + 4 * b * nd * (s + 3 * v)
               + 4 * b * p * (s + 3 * h0) + 8 * grads)
    fwd = (h0 * s + s * v + 3 * h0 * v
           + n_j * (3 * v * hj + s * s + hj * s + s * v + 3 * hj * v))
    bwd = (2 * s * v + 6 * h0 * v + r * s + 2 * h0 * s + 3 * h0
           + n_j * (2 * s * v + 12 * v * hj + 2 * s * s + 2 * hj * s))
    rows = int(edge.mask.sum()) * copies
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
                        lambda: resumed.train_step(batch))
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
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    phase_build()
    knn = phase_knn(dev)
    phase_golden(dev)
    dev_launches = phase_main(dev, profile)
    pp = phase_pp(dev)
    full_launches = phase_fullscale(dev, profile)
    ppbwd = phase_ppbwd(dev)
    train_launches = phase_train(dev, profile)
    kernels = [knn, pp, ppbwd]
    for kern in kernels:
        # `launches`: this slice's main path, the 2-epoch training run
        kern["launches"] = train_launches[kern["name"]]
        kern["launches_fullscale_chain"] = full_launches[kern["name"]]
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
