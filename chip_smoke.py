#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`pharmaforge_tpu_torch`).

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # also traces chains with torch.profiler

Phases, one line each; any failure raises and the script exits non-zero:

1. build     -- compile every CUDA kernel of the sampling path from
                `pharmaforge_tpu_torch/csrc` (nvcc, sm_90a; one nvcc per
                source, all started together);
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
                on the card: the sampling shape (B=120 = 4 pockets x 30
                copies, P=Nd=230, K=16, S=128, V=16, 3 GVPs) in bf16 and
                fp32, and edge cases (copies=1 with Nd=40, hidden width
                V+1, a fully masked destination, K=1, an odd batch);
                device times of the kernel and the plain version, the
                bound, the eager time;
6. fullscale -- the reference-size model (n_convs=4, T=1000, endpoint,
                bf16 edge chains, same widths, random weights from a seed)
                sampling 4 synthetic 230-atom pockets x 30 through
                `PocketSampler.sample_stacked` (B=120): finite zero-padded
                output, exactly 2,000 K2 and 1,000 K1 launches per chain,
                samples/s over timed chains after a warm-up; and the same
                model in fp32 over 20 steps, 1 pocket x 8, on the card and
                on the CPU with the same injected noise, within 2e-3.

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
KERNELS = ("knn_select", "pp_message")


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


def kernel_modules():
    from pharmaforge_tpu_torch.ops import knn_select, pp_message
    return {"knn_select": knn_select, "pp_message": pp_message}


def reset_launches() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in kernel_modules().items()}


def expected_launches(cfg) -> dict:
    """One chain of `cfg`: K1 once per denoiser call (knn pf), K2 once per
    middle conv (convs 1 .. n-2) per call."""
    t = cfg.n_timesteps
    return {"knn_select": t if cfg.pf_k else 0,
            "pp_message": t * max(cfg.n_convs - 2, 0) if cfg.fused_pp else 0}


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    gen.manual_seed(9)
    sampler.sample_stacked(pockets, n_pharms, gen)      # warm-up
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

    # device-side events only (kernels, copies): the host ops that launch
    # them report the same time again
    events = [e for e in p.key_averages()
              if e.device_type == DeviceType.CUDA and self_us(e) > 0]
    busy = sum(self_us(e) for e in events) / 1e6
    top = sorted(events, key=lambda e: -self_us(e))[:12]
    per_kernel = []
    for kname in KERNELS:
        evs = [e for e in events if f"{kname}_kernel" in e.key]
        n = sum(e.count for e in evs)
        per_kernel.append(f"{kname}_kernel {sum(self_us(e) for e in evs) / max(n, 1):.2f} "
                          f"us per launch x{n}")
    print(f"profile {name}: chain of T={steps} wall {wall:.4f} s under the "
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
            masked_row: bool = False, s: int = 128, v: int = 16):
    """One K2 call as the main path makes it: the pp edges of synthetic
    pockets at pocket-group level, random node tables in the compute
    dtype, a message chain with seeded weights. `nd` picks that many
    destination atoms per row (the compact-tail call, one row per
    group)."""
    from pharmaforge_tpu_torch.models.conv import message_specs
    from pharmaforge_tpu_torch.models.edges import (EdgeData,
                                                    GroupedEdgeData,
                                                    build_pp_edge)
    from pharmaforge_tpu_torch.models.gvp import GVPChain, reset_parameters_
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    pockets = synthetic_pockets(4, atoms)
    prot_x = np.zeros((n_groups, atoms, 3), np.float32)
    prot_mask = np.zeros((n_groups, atoms), bool)
    for i in range(n_groups):
        px = pockets[i % len(pockets)]["prot_x"]
        prot_x[i, :len(px)] = px
        prot_mask[i, :len(px)] = True
    _, ed = build_pp_edge(torch.from_numpy(prot_x).to(dev),
                          torch.from_numpy(prot_mask).to(dev), 3.5, k)
    gen = torch.Generator(device=dev).manual_seed(n_groups * 100 + k)
    if nd is not None:
        sel = torch.argsort(torch.rand(n_groups, atoms, generator=gen,
                                       device=dev), dim=1)[:, :nd]
        ed = EdgeData(*(torch.take_along_dim(
            a, sel.reshape(sel.shape + (1,) * (a.dim() - 2)), dim=1)
            for a in ed))
    if masked_row:
        ed = ed._replace(mask=ed.mask.clone())
        ed.mask[:, 3] = False
    edge = GroupedEdgeData(*ed, copies=copies) if copies > 1 else ed
    specs = message_specs(3, v, s, 16)
    specs[1:] = [dict(sp, hidden_vectors=hj) for sp in specs[1:]]
    chain = reset_parameters_(GVPChain(specs),
                              torch.Generator().manual_seed(7)).to(dev)
    b = n_groups * copies
    pre_s = torch.randn(b, atoms, s, generator=gen, device=dev).to(dt)
    planes = [(0.5 * torch.randn(b, atoms, v + 1, generator=gen,
                                 device=dev)).to(dt) for _ in range(3)]
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


def phase_pp(dev) -> dict:
    from pharmaforge_tpu_torch.ops import pp_message as ppm
    cases = [("main", {}),
             ("compact Nd=40 copies=1", dict(n_groups=120, copies=1, nd=40)),
             ("hj=V+1", dict(n_groups=2, copies=3, hj=17)),
             ("masked destination", dict(n_groups=2, copies=3,
                                         masked_row=True)),
             ("K=1", dict(n_groups=2, copies=3, k=1)),
             ("odd batch B=3", dict(n_groups=3, copies=1))]
    errs = {}
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            for name, extra in cases:
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

        args, kw = pp_case(dev, dtype="bfloat16")
        eager_ms = cuda_ms(lambda: ppm.fused_message_agg(*args, **kw),
                           reps=20, warmup=2)
        kernel_ms = graph_ms(lambda: ppm.fused_message_agg(*args, **kw),
                             calls=20, replays=5)
        plain_ms = graph_ms(lambda: ppm.message_agg_reference(*args, **kw),
                            calls=2, replays=3)
        args32, kw32 = pp_case(dev, dtype="float32")
        fp32_ms = graph_ms(lambda: ppm.fused_message_agg(*args32, **kw32),
                           calls=10, replays=3)
    n_bytes, n_ops, n_rows = pp_bound(args, kw)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_BF16_OPS
    (b, p, s), (g, nd, k) = args[0].shape, args[2].mask.shape
    print(f"pp: {len(errs)} cases within tolerance of the plain version "
          f"(fp32 {PP_TOL['float32']}, bf16 {PP_TOL['bfloat16']}); max abs "
          f"err {json.dumps(errs)}; main shape B={b} (G={g} x "
          f"{kw['copies']} copies) P={p} Nd={nd} K={k} S={s} "
          f"V={kw['vector_size']} ({n_rows} of {b * nd * k} slots are "
          f"edges), per call from CUDA-graph replay: "
          f"kernel bf16 {kernel_ms:.4f} ms, fp32 {fp32_ms:.4f} ms, plain "
          f"bf16 {plain_ms:.4f} ms; bound {max(t_bytes, t_ops) * 1e3:.6f} ms "
          f"({n_bytes} B at 3.35 TB/s, {n_ops} ops at 989 TFLOP/s bf16; "
          f"{n_ops / PEAK_FP32_OPS * 1e3:.4f} ms at 67 TFLOP/s fp32); "
          f"kernel called eagerly back to back {eager_ms:.4f} ms",
          flush=True)
    return {"name": "pp_message", "route": "cuda",
            "source": "pharmaforge_tpu_torch/csrc/pp_message.cu",
            "replaces": "pharmaforge_tpu/ops/pallas/pp_message.py:386",
            "max_abs_err": errs["main bfloat16"], "ms": kernel_ms,
            "kernel_ms": kernel_ms, "fp32_ms": fp32_ms,
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


# -------------------------------------------------------------- fullscale

def phase_fullscale(dev, profile: bool = False) -> dict:
    return phase_sampling("fullscale", dev, full_config(), n_pockets=4,
                          per_pocket=30, atoms=230, timed=2, cmp_steps=20,
                          profile=profile)


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
    for kern in (knn, pp):
        kern["launches"] = full_launches[kern["name"]]
        kern["launches_dev_chain"] = dev_launches[kern["name"]]
    print(card())
    print(json.dumps({"kernels": [knn, pp]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
