"""PyTorch/CUDA port, slice 2: the fused prot-prot message chain
(`pharmaforge_tpu_torch.ops.pp_message`, K2) and the reference-size model
(n_convs=4, bf16 edge chains, endpoint) against the JAX package on the
CPU.

The same numpy inputs (seeded) and weights go through the JAX function and
the port. Tolerances:
* K2's plain version against the JAX twin and the JAX Pallas kernel in
  interpret mode: fp32 rtol 1e-5 / atol 1e-6 (the JAX kernel-vs-twin
  tolerance, tests/test_pp_fused.py:93-96). bf16 against the JAX twin:
  rtol 8e-3 (two bf16 ulps) / atol 1e-3; both round at the same points
  and agree to the bit on this CPU. bf16 against the interpreted JAX
  kernel: the JAX bf16 bound, rtol 0.08 / atol 0.05 (test_pp_fused.py:39),
  because that kernel itself differs from its own twin in bf16 (by up to
  0.11 on sums of magnitude 13.5 here; ROADMAP C).
* the wrapper on grouped descriptors against expanded ones: 1e-5.
* the fused conv: rtol 2e-4 / atol 2e-5 (test_pp_fused.py:147).
* one n_convs=4 denoiser forward: fp32 rtol 1e-4 / atol 1e-5
  (test_pp_fused.py:180); bf16 against the JAX bf16 forward rtol 0.05 /
  atol 1e-3: the port's unfused edge chains are the concatenation form and
  the JAX package's the hoisted form, which round at other points in bf16
  (measured max 9.9e-5 against outputs up to 0.15 on these inputs).
* the n_convs=4 endpoint chain: 2e-3 against the JAX package (its
  full-chain tolerance); grouped against ungrouped: 2e-4.
JAX matmuls run in full fp32 (tests/conftest.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pharmaforge_tpu.data.batch import PharmComplexBatch as JaxBatch
from pharmaforge_tpu.models import conv as jconv
from pharmaforge_tpu.models import edges as jedges
from pharmaforge_tpu.models.diffusion import (
    DiffusionConfig as JaxConfig,
    PharmacophoreDiffusion as JaxDiffusion,
)
from pharmaforge_tpu.ops.geometry import rbf as jax_rbf
from pharmaforge_tpu.ops.pallas import pp_message as jppm
from pharmaforge_tpu_torch.data.batch import PharmComplexBatch, tile_pocket
from pharmaforge_tpu_torch.interop import flatten, key_map, params_from_jax
from pharmaforge_tpu_torch.models import conv as tconv
from pharmaforge_tpu_torch.models import edges as tedges
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)
from pharmaforge_tpu_torch.models.gvp import GVP
from pharmaforge_tpu_torch.ops import pp_message as ppm

CUTOFFS = {"pp": 3.5, "pf": 8.0, "fp": 8.0, "ff": 9.0}
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=8e-3, atol=1e-3)}
JAX_BF16 = dict(rtol=0.08, atol=0.05)


def t(a):
    return torch.from_numpy(np.array(a))


def allclose(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32), **tol)


# ------------------------------------------------------------- K2 alone

def k2_case(rng, g=2, copies=1, p=17, nd=11, k=4, s=16, v=4, r=8, hj=None,
            n_gvps=3):
    """Node tables, group-level edge descriptors and raw GVP weights (the
    JAX layout) for one K2 call."""
    h = v + 1
    hj = v if hj is None else hj
    b = g * copies
    pre_s = rng.normal(size=(b, p, s)).astype(np.float32)
    planes = [rng.normal(size=(b, p, h)).astype(np.float32)
              for _ in range(3)]
    idx = rng.integers(0, p, size=(g, nd, k)).astype(np.int32)
    mask = (rng.random((g, nd, k)) < 0.8).astype(np.float32)
    mask[:, -2:] = 0.0                  # destinations with no valid edge
    d = rng.uniform(0.5, 10.0, size=(g, nd, k)).astype(np.float32)
    x_dir = rng.normal(size=(g, nd, k, 3)).astype(np.float32)
    x_dir /= np.linalg.norm(x_dir, axis=-1, keepdims=True)
    d_rbf = np.asarray(jax_rbf(jnp.asarray(d), d_count=r))

    def mk(shape):
        return rng.normal(scale=0.3, size=shape).astype(np.float32)

    layers = [(mk((h, h)), mk((h, v)), (mk((s + r + h, s)), mk((s,))),
               (mk((s, v)), mk((v,))))]
    for _ in range(n_gvps - 1):
        layers.append((mk((v, hj)), mk((hj, v)), (mk((s + hj, s)), mk((s,))),
                       (mk((s, v)), mk((v,)))))
    return dict(pre_s=pre_s, planes=planes, idx=idx, mask=mask, x_dir=x_dir,
                d_rbf=d_rbf, layers=layers, s=s, v=v, r=r, h=h, hj=hj,
                copies=copies)


def jax_side(c):
    edge = jedges.EdgeData(mask=jnp.asarray(c["mask"]),
                           idx=jnp.asarray(c["idx"]),
                           x_dir=jnp.asarray(c["x_dir"]),
                           d_rbf=jnp.asarray(c["d_rbf"]))
    if c["copies"] > 1:
        edge = jedges.GroupedEdgeData(mask=edge.mask, idx=edge.idx,
                                      x_dir=edge.x_dir, d_rbf=edge.d_rbf,
                                      copies=c["copies"])
    layers = jax.tree.map(jnp.asarray, c["layers"])
    return (jnp.asarray(c["pre_s"]), [jnp.asarray(q) for q in c["planes"]],
            edge, layers)


def port_gvps(c):
    """The JAX weights as the port's GVP modules."""
    gvps = []
    for i, (wh, wu, (w1, b1), (wg, bg)) in enumerate(c["layers"]):
        first = i == 0
        m = GVP(c["h"] if first else c["v"], c["v"],
                c["s"] + c["r"] if first else c["s"], c["s"],
                hidden_vectors=c["h"] if first else c["hj"])
        m.load_state_dict({
            "Wh": t(wh), "Wu": t(wu),
            "to_feats_out.0.weight": t(w1.T), "to_feats_out.0.bias": t(b1),
            "scalar_to_vector_gates.weight": t(wg.T),
            "scalar_to_vector_gates.bias": t(bg)})
        gvps.append(m)
    return gvps


def port_edge(c, expand=False):
    edge = tedges.EdgeData(t(c["mask"]), t(c["idx"]).long(), t(c["x_dir"]),
                           t(c["d_rbf"]))
    if c["copies"] > 1:
        grouped = tedges.GroupedEdgeData(*edge, copies=c["copies"])
        return grouped.expand() if expand else grouped
    return edge


def kw_of(c, dtype):
    return dict(scalar_size=c["s"], vector_size=c["v"], rbf_dim=c["r"],
                compute_dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("copies", [1, 3])
@pytest.mark.parametrize("hj_extra", [0, 1])
def test_plain_matches_jax_twin_and_interpreted_kernel(rng, dtype, copies,
                                                       hj_extra):
    c = k2_case(rng, copies=copies, hj=4 + hj_extra)
    kw = kw_of(c, dtype)
    j_pre, j_planes, j_edge, j_layers = jax_side(c)
    want_twin = jppm.message_agg_reference(j_pre, j_planes, j_edge,
                                           j_layers, copies=copies, **kw)
    want_kernel = jppm.fused_message_agg(j_pre, j_planes, j_edge, j_layers,
                                         copies=copies, interpret=True,
                                         **kw)
    got = ppm.message_agg_reference(
        t(c["pre_s"]), [t(q) for q in c["planes"]], port_edge(c),
        port_gvps(c), copies=copies, **kw)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[1].shape == (2 * copies, 11, 4, 3)
    kernel_tol = TOL[dtype] if dtype == "float32" else JAX_BF16
    for g_, w_t, w_k in zip(got, want_twin, want_kernel):
        allclose(g_, w_t, **TOL[dtype])
        allclose(g_, w_k, **kernel_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_twin_for_a_five_gvp_chain(rng, dtype):
    """A deeper message chain (n_message_gvps=5, whose bf16 weights K2
    stages per GVP on the card) against the JAX twin and the interpreted
    JAX kernel, tolerances as above."""
    c = k2_case(rng, copies=3, n_gvps=5)
    kw = kw_of(c, dtype)
    j_pre, j_planes, j_edge, j_layers = jax_side(c)
    want_twin = jppm.message_agg_reference(j_pre, j_planes, j_edge,
                                           j_layers, copies=3, **kw)
    want_kernel = jppm.fused_message_agg(j_pre, j_planes, j_edge, j_layers,
                                         copies=3, interpret=True, **kw)
    gvps = port_gvps(c)
    assert len(ppm.split_weights(gvps, c["s"], c["r"])) == 7 * 5
    got = ppm.message_agg_reference(
        t(c["pre_s"]), [t(q) for q in c["planes"]], port_edge(c), gvps,
        copies=3, **kw)
    kernel_tol = TOL[dtype] if dtype == "float32" else JAX_BF16
    for g_, w_t, w_k in zip(got, want_twin, want_kernel):
        allclose(g_, w_t, **TOL[dtype])
        allclose(g_, w_k, **kernel_tol)


def test_wrapper_on_cpu_is_the_plain_version_grouped_equals_expanded(rng):
    c = k2_case(rng, copies=3)
    gvps, kw = port_gvps(c), kw_of(c, "float32")
    pre_s, planes = t(c["pre_s"]), [t(q) for q in c["planes"]]
    before = ppm.launches
    with torch.no_grad():
        grouped = ppm.fused_message_agg(pre_s, planes, port_edge(c), gvps,
                                        copies=3, **kw)
        expanded = ppm.fused_message_agg(pre_s, planes,
                                         port_edge(c, expand=True), gvps,
                                         **kw)
        plain = ppm.message_agg_reference(pre_s, planes, port_edge(c), gvps,
                                          copies=3, **kw)
    assert ppm.launches == before        # no kernel on the CPU
    for a, b, p in zip(grouped, expanded, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(a, p)


def test_wrapper_raises_on_grad_and_other_devices(rng):
    c = k2_case(rng)
    gvps, kw = port_gvps(c), kw_of(c, "float32")
    planes = [t(q) for q in c["planes"]]
    # the GVP parameters require grad: differentiable (K3 on the card);
    # the edge geometry gets no gradient and must not require one
    s_sum, _ = ppm.fused_message_agg(t(c["pre_s"]), planes, port_edge(c),
                                     gvps, **kw)
    assert s_sum.requires_grad
    edge = port_edge(c)
    edge = edge._replace(x_dir=edge.x_dir.requires_grad_(True))
    with pytest.raises(RuntimeError, match="geometry"):
        ppm.fused_message_agg(t(c["pre_s"]), planes, edge, gvps, **kw)
    with torch.no_grad():
        ppm.fused_message_agg(t(c["pre_s"]), planes, edge, gvps, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        with torch.no_grad():
            ppm.fused_message_agg(t(c["pre_s"]).to("meta"), planes,
                                  port_edge(c), gvps, **kw)


def test_split_and_packed_weights_follow_the_kernel_layout(rng):
    c = k2_case(rng, s=8, v=3, hj=5)
    w = ppm.split_weights(port_gvps(c), 8, 8)
    wh, wu, (w1, b1), (wg, bg) = c["layers"][0]
    np.testing.assert_array_equal(w[0].detach().numpy(), wh[0])
    np.testing.assert_array_equal(w[2].detach().numpy(), w1[8:16])
    np.testing.assert_array_equal(w[3].detach().numpy(), w1[16:])
    packed = ppm._pack_weights(tuple(a.detach() for a in w), torch.float32)
    # GVP 0: w1_sh [4,8], wg [8,3], bg [3], wu [4,3]; each later GVP:
    # wh [3,5], wu [5,3], w1f [8,8], w1sh [5,8], b1, wg [8,3], bg [3],
    # every block padded to a multiple of 8 elements
    pad = [-(-n // 8) * 8 for n in (32, 24, 3, 12)]
    pad_j = [-(-n // 8) * 8 for n in (15, 15, 64, 40, 8, 24, 3)]
    assert packed.numel() == sum(pad) + 2 * sum(pad_j)
    np.testing.assert_array_equal(packed[:32].numpy(),
                                  w1[16:].reshape(-1))
    assert not packed[sum(pad[:2]) + 3:sum(pad[:3])].any()   # bg padding


# ---------------------------------------------------------------- the conv

S, V = 32, 8


def conv_inputs(rng, copies=2, n_pockets=2, f=8, p=32):
    """Pocket-major rows (`copies` per pocket) with per-row node state and
    nonzero vectors: the middle-conv regime."""
    b = copies * n_pockets
    prot_x = np.repeat(rng.normal(scale=3.0, size=(n_pockets, p, 3)),
                       copies, 0).astype(np.float32)
    prot_mask = np.repeat(np.arange(p)[None] < rng.integers(
        p - 6, p + 1, n_pockets)[:, None], copies, 0)
    pharm_x = rng.normal(scale=3.0, size=(b, f, 3)).astype(np.float32)
    pharm_mask = np.arange(f)[None] < rng.integers(3, f + 1, b)[:, None]
    feats = {}
    for nt, x, m in (("pharm", pharm_x, pharm_mask),
                     ("prot", prot_x, prot_mask)):
        h = rng.normal(size=m.shape + (S,)).astype(np.float32) * m[..., None]
        v = (rng.normal(scale=0.4, size=m.shape + (V, 3)).astype(np.float32)
             * m[..., None, None])
        feats[nt] = (h, x, v)
    return feats, {"pharm": pharm_mask, "prot": prot_mask}


def conv_state_dict(params, n_msg, n_upd):
    flat = flatten(params)
    pre = "dynamics.noise_predictor.conv_layers.0."
    sd = {}
    for tkey, (fkey, tr) in key_map(1, n_msg, n_upd, 1, False).items():
        if tkey.startswith(pre):
            arr = np.asarray(flat[fkey[len("conv_layers_0."):]])
            sd[tkey[len(pre):]] = t(arr.T if tr else arr)
    return sd


@pytest.mark.parametrize("message_norm", ["mean", 10, 0])
def test_fused_conv_matches_jax_and_unfused(rng, message_norm):
    copies = 2
    feats, masks = conv_inputs(rng, copies=copies)
    px, pm = feats["prot"][1], masks["prot"]
    feats_j = {k: tuple(jnp.asarray(a) for a in v) for k, v in feats.items()}
    masks_j = {k: jnp.asarray(v) for k, v in masks.items()}
    _, ed = jedges.build_pp_edge(jnp.asarray(px[::copies]),
                                 jnp.asarray(pm[::copies]), 3.5, 8)
    pp_j = jedges.GroupedEdgeData(ed.mask, ed.idx, ed.x_dir, ed.d_rbf,
                                  copies=copies)
    bundle_j = jedges.build_edge_bundle(
        feats_j["pharm"][1], masks_j["pharm"], feats_j["prot"][1],
        masks_j["prot"], CUTOFFS, ff_k=0, pf_k=4, pp_nbrs=None, pp_edge=pp_j)
    jmod = jconv.GVPMultiEdgeConv(scalar_size=S, vector_size=V,
                                  n_message_gvps=3, n_update_gvps=1,
                                  message_norm=message_norm,
                                  fused_pp="interpret")
    params = jmod.init(jax.random.key(1), feats_j, masks_j,
                       bundle_j)["params"]
    want = jmod.apply({"params": params}, feats_j, masks_j, bundle_j)

    feats_t = {k: tuple(t(a) for a in v) for k, v in feats.items()}
    masks_t = {k: t(v) for k, v in masks.items()}
    _, ed = tedges.build_pp_edge(t(px[::copies]), t(pm[::copies]), 3.5, 8)
    pp_t = tedges.GroupedEdgeData(*ed, copies=copies)
    bundle_t = tedges.build_edge_bundle(
        feats_t["pharm"][1], masks_t["pharm"], feats_t["prot"][1],
        masks_t["prot"], CUTOFFS, ff_k=0, pf_k=4, pp_edge=pp_t)
    outs = {}
    for fused in (True, False):
        tmod = tconv.GVPMultiEdgeConv(scalar_size=S, vector_size=V,
                                      n_message_gvps=3, n_update_gvps=1,
                                      message_norm=message_norm,
                                      fused_pp=fused)
        tmod.load_state_dict(conv_state_dict(params, 3, 1))
        with torch.no_grad():
            outs[fused] = tmod(feats_t, masks_t, bundle_t)
    for nt in ("pharm", "prot"):
        for i in (0, 2):
            allclose(outs[True][nt][i], want[nt][i], rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(outs[True][nt][i].numpy(),
                                       outs[False][nt][i].numpy(),
                                       rtol=2e-4, atol=2e-5)


# ---------------------------------------------------- denoiser and chain

def full_scale_kw(**kw):
    """The reference-size model's structure (n_convs=4, 3/2/3 GVPs, knn
    pf, mean norm) at test widths."""
    base = dict(n_timesteps=8, vector_size=V, n_convs=4,
                n_hidden_scalars=S, n_message_gvps=3, n_update_gvps=2,
                n_noise_gvps=3, message_norm="mean", pf_k=4, ff_k=0,
                pp_k_max=8, precision=1e-5, fused_pp="interpret")
    base.update(kw)
    return base


def pockets_batch(rng, n_pockets=2, copies=3, p=32, t_steps=8):
    """`n_pockets` pockets x `copies` rows, pocket-major, plus noise."""
    rows = []
    for _ in range(n_pockets):
        px = rng.normal(scale=3.0, size=(p - 4, 3)).astype(np.float32)
        ph = np.eye(11, dtype=np.float32)[rng.integers(0, 11, p - 4)]
        rows.append(tile_pocket(px, ph, rng.integers(3, 9, copies),
                                max_prot=p))
    batch = PharmComplexBatch(**{
        f.name: np.concatenate([getattr(r, f.name) for r in rows])
        for f in dataclasses.fields(PharmComplexBatch)})
    b = batch.batch_size
    noise = {"x_T": rng.normal(size=(b, 8, 3)),
             "h_T": rng.normal(size=(b, 8, 6)),
             "pos": rng.normal(size=(t_steps, b, 8, 3)),
             "feat": rng.normal(size=(t_steps, b, 8, 6))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    com = rng.normal(scale=2.0, size=(b, 3)).astype(np.float32)
    return batch, noise, com


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoiser_n_convs4_matches_jax(rng, dtype):
    kw = full_scale_kw(compute_dtype=dtype)
    batch, _, _ = pockets_batch(rng)
    batch = dataclasses.replace(
        batch, pharm_x=rng.normal(scale=3.0, size=batch.pharm_x.shape)
        .astype(np.float32) * batch.pharm_mask[..., None],
        pharm_h=rng.normal(size=batch.pharm_h.shape).astype(np.float32)
        * batch.pharm_mask[..., None])
    jbatch = JaxBatch(**dataclasses.asdict(batch))
    jmodel = JaxDiffusion(JaxConfig(**kw))
    params = jax.device_get(jmodel.init_params(jax.random.key(3), jbatch))
    tv = np.repeat(np.float32([0.3, 0.8]), 3)
    j_px, j_pm = jnp.asarray(batch.prot_x), jnp.asarray(batch.prot_mask)
    pp_nbrs, pp_edge = jedges.build_pp_edge(j_px, j_pm, 3.5, 8)
    want = jmodel.dynamics.apply(
        {"params": params}, jnp.asarray(batch.pharm_h),
        jnp.asarray(batch.pharm_x), jnp.asarray(batch.pharm_mask),
        jnp.asarray(batch.prot_h), j_px, j_pm, jnp.asarray(tv), pp_nbrs,
        pp_edge=pp_edge)

    cfg = DiffusionConfig(**kw)
    model = PharmacophoreDiffusion(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    px, pm = t(batch.prot_x), t(batch.prot_mask)
    _, pp_t = tedges.build_pp_edge(px, pm, 3.5, 8)
    with torch.no_grad():
        got = model.dynamics(t(batch.pharm_h), t(batch.pharm_x),
                             t(batch.pharm_mask), t(batch.prot_h), px, pm,
                             t(tv), pp_edge=pp_t)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else \
        dict(rtol=0.05, atol=1e-3)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        allclose(g_, w_, **tol)
    assert not got[0][~t(batch.pharm_mask)].any()


def test_endpoint_chain_n_convs4_matches_jax(rng):
    kw = full_scale_kw(endpoint_param_feat=True, endpoint_param_coord=True)
    batch, noise, com = pockets_batch(rng)
    jmodel = JaxDiffusion(JaxConfig(**kw))
    jbatch = JaxBatch(**dataclasses.asdict(batch))
    params = jax.device_get(jmodel.init_params(jax.random.key(5), jbatch))
    want = jmodel.sample_given_receptor(
        params, jbatch, jax.random.key(0), init_pharm_com=com, noise=noise,
        pocket_group_size=3, pp_k_out=0)

    cfg = DiffusionConfig(**kw)
    model = PharmacophoreDiffusion(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    run = dict(init_pharm_com=com, noise=noise)
    grouped = model.sample_given_receptor(batch, pocket_group_size=3, **run)
    flat = model.sample_given_receptor(batch, pocket_group_size=1, **run)
    for key in ("pharm_x", "pharm_h"):
        np.testing.assert_allclose(grouped[key].numpy(),
                                   np.asarray(want[key]), atol=2e-3, rtol=0,
                                   err_msg=key)
        np.testing.assert_allclose(grouped[key].numpy(), flat[key].numpy(),
                                   atol=2e-4, rtol=0, err_msg=key)


def test_params_from_jax_n_convs4_covers_every_key(rng):
    kw = full_scale_kw(compute_dtype="bfloat16")
    batch, _, _ = pockets_batch(rng, n_pockets=1, copies=2)
    params = jax.device_get(JaxDiffusion(JaxConfig(**kw)).init_params(
        jax.random.key(0), JaxBatch(**dataclasses.asdict(batch))))
    cfg = DiffusionConfig(**kw)
    model = PharmacophoreDiffusion(cfg, device="cpu")
    sd = params_from_jax(params, cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)           # strict: nothing missing or extra
    assert any(".conv_layers.3." in k for k in sd)
    assert not any(".conv_layers.3." in k and "_prot" in k for k in sd)


def test_full_scale_config_is_supported_but_pp_k_out_raises(rng):
    full = DiffusionConfig(n_convs=4, n_timesteps=1000,
                           compute_dtype="bfloat16",
                           endpoint_param_feat=True,
                           endpoint_param_coord=True, fused_pp="auto",
                           pf_k=5, pp_k_max=16, message_norm="mean")
    full.check_supported()
    model = PharmacophoreDiffusion(DiffusionConfig(**full_scale_kw(
        compute_dtype="bfloat16", fused_pp="auto")), device="cpu")
    convs = model.dynamics.noise_predictor.conv_layers
    assert all(c.fused_pp and c.dtype == torch.bfloat16 for c in convs)
    batch, noise, _ = pockets_batch(rng)
    # the correction is ported; a pp_k_out below the pp graph's maximum
    # out-degree raises rather than drop edges
    with pytest.raises(ValueError, match="pp_k_out"):
        model.sample_given_receptor(batch, noise=noise, pocket_group_size=3,
                                    pp_k_out=1)


@pytest.mark.parametrize("n_convs,fused_pp,calls", [
    (4, "auto", 2), (4, False, 0), (2, True, 0), (3, True, 1)])
def test_fused_branch_runs_on_the_middle_convs_only(rng, monkeypatch,
                                                    n_convs, fused_pp,
                                                    calls):
    """The JAX gate (conv.py:850-852): a gathered pp edge, nonzero source
    vectors, no pocket-group dedup -- convs 1 .. n-2, grouped pp edges
    passed through at group level, except on the compact conv (n-2),
    whose call takes the 6 copies' F*K compact slots (copies=1)."""
    seen = []

    def spy(*args, **kw):
        seen.append((kw["copies"], args[2].mask.shape[0]))
        return ppm.fused_message_agg(*args, **kw)

    monkeypatch.setattr(tconv, "fused_message_agg", spy)
    model = PharmacophoreDiffusion(DiffusionConfig(**full_scale_kw(
        n_convs=n_convs, fused_pp=fused_pp, n_timesteps=2)), device="cpu")
    batch, noise, _ = pockets_batch(rng, t_steps=2)
    model.sample_given_receptor(batch, noise=noise, pocket_group_size=3)
    step = [(3, 2)] * (calls - 1) + [(1, 6)] if calls else []
    assert seen == step * 2                  # 2 steps, G=2 groups x 3
