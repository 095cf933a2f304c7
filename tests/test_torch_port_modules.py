"""PyTorch/CUDA port, module by module against the JAX package on the CPU.

The same numpy inputs (seeded) and the same weights (carried from the
Flax init through the port's key map) go through each JAX module and its
port. Tolerances: schedules and neighbor indices exact (tie order
included); geometry and the chain's transition parameters 1e-6; GVP,
GVPLayerNorm and GVPMultiEdgeConv 2e-4 (the JAX conv tests' tolerance);
one denoiser forward 1e-4. JAX matmuls run in full fp32
(tests/conftest.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.models import conv as jconv
from pharmaforge_tpu.models import diffusion as jdiff
from pharmaforge_tpu.models import edges as jedges
from pharmaforge_tpu.models import gvp as jgvp
from pharmaforge_tpu.models.diffusion import (
    DiffusionConfig as JaxConfig,
    PharmacophoreDiffusion as JaxDiffusion,
)
from pharmaforge_tpu.models.schedules import make_gamma_table as jax_gamma
from pharmaforge_tpu.ops import geometry as jgeo
from pharmaforge_tpu.ops import neighbors as jnb
from pharmaforge_tpu_torch.interop import (
    GVP_LEAVES,
    flatten,
    key_map,
    params_from_jax,
)
from pharmaforge_tpu_torch.models import conv as tconv
from pharmaforge_tpu_torch.models import diffusion as tdiff
from pharmaforge_tpu_torch.models import edges as tedges
from pharmaforge_tpu_torch.models import gvp as tgvp
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)
from pharmaforge_tpu_torch.models.schedules import make_gamma_table
from pharmaforge_tpu_torch.ops import geometry as tgeo
from pharmaforge_tpu_torch.ops import neighbors as tnb

CUTOFFS = {"pp": 3.5, "pf": 8.0, "fp": 8.0, "ff": 9.0}
S, V = 32, 8


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=0)


# ------------------------------------------------------- schedules, geometry

@pytest.mark.parametrize("schedule", ["polynomial_2", "cosine"])
@pytest.mark.parametrize("steps", [100, 1000])
def test_gamma_table_equals_jax(schedule, steps):
    np.testing.assert_array_equal(make_gamma_table(schedule, steps, 1e-5),
                                  jax_gamma(schedule, steps, 1e-5))


def test_geometry_matches_jax(rng):
    x = rng.normal(scale=3.0, size=(3, 7, 3)).astype(np.float32)
    x[0, 2] = 0.0                      # a zero vector hits the clamp
    mask = rng.random((3, 7)) > 0.3
    mask[2] = False                    # an empty set has COM 0
    close(tgeo.norm_no_nan(t(x)), jgeo.norm_no_nan(jnp.asarray(x)), 1e-6)
    d = np.abs(x[..., 0]) * 4
    close(tgeo.rbf(t(d), d_max=15.0), jgeo.rbf(jnp.asarray(d), d_max=15.0),
          1e-6)
    close(tgeo.masked_com(t(x), t(mask)),
          jgeo.masked_com(jnp.asarray(x), jnp.asarray(mask)), 1e-6)
    y = rng.normal(scale=3.0, size=(3, 5, 3)).astype(np.float32)
    for got, want in zip(
            tgeo.remove_masked_com(t(x), t(mask), t(y)),
            jgeo.remove_masked_com(jnp.asarray(x), jnp.asarray(mask),
                                   jnp.asarray(y))):
        close(got, want, 1e-6)


def test_transition_parameters_match_jax():
    gamma = make_gamma_table("polynomial_2", 100, 1e-5).astype(np.float32)
    g = t(gamma)
    close(tdiff.sigma_of_gamma(g), jdiff.sigma_of_gamma(gamma), 1e-6)
    close(tdiff.alpha_of_gamma(g), jdiff.alpha_of_gamma(gamma), 1e-6)
    for got, want in zip(tdiff.sigma_and_alpha_t_given_s(g[1:], g[:-1]),
                         jdiff.sigma_and_alpha_t_given_s(gamma[1:],
                                                         gamma[:-1])):
        close(got, want, 1e-6)


# -------------------------------------------------------------- neighbors

def tied_points(rng, b=3, n=24):
    x = rng.normal(scale=2.5, size=(b, n, 3)).astype(np.float32)
    x[0, 9] = x[0, 2]                  # duplicate coordinates: exact ties
    x[1, 5] = x[1, 17] = x[1, 3]
    mask = np.ones((b, n), bool)
    mask[2, 15:] = False
    return x, mask


@pytest.mark.parametrize("k", [3, 12])
def test_smallest_k_tie_order_equals_jax(rng, k):
    # small integers: most values tie; k=3 takes JAX's argmin passes,
    # k=12 its lax.top_k path
    d2 = rng.integers(0, 5, size=(4, 6, 20)).astype(np.float32)
    v_t, i_t = tnb.smallest_k(t(d2), k)
    v_j, i_j = jnb.smallest_k(jnp.asarray(d2), k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_radius_neighbor_list_equals_jax(rng):
    x, mask = tied_points(rng)
    got = tnb.radius_neighbor_list(t(x), t(mask), 3.5, 10)
    want = jnb.radius_neighbor_list(jnp.asarray(x), jnp.asarray(mask),
                                    3.5, 10)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_and_radius_masks_equal_jax(rng, exclude_self):
    x, mask = tied_points(rng)
    args_t, args_j = (t(x), t(mask)), (jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_array_equal(
        tnb.knn_mask(*args_t, *args_t, 4, exclude_self=exclude_self).numpy(),
        np.asarray(jnb.knn_mask(*args_j, *args_j, 4,
                                exclude_self=exclude_self)))
    np.testing.assert_array_equal(
        tnb.radius_mask(*args_t, *args_t, 3.0,
                        exclude_self=exclude_self).numpy(),
        np.asarray(jnb.radius_mask(*args_j, *args_j, 3.0,
                                   exclude_self=exclude_self)))


# -------------------------------------------------------------------- GVP

def gvp_state(flat):
    return {tk: t(np.asarray(flat[fk]).T.copy() if tr else flat[fk])
            for tk, (fk, tr) in GVP_LEAVES.items()}


@pytest.mark.parametrize("vec_act", ["sigmoid", "identity"])
def test_gvp_matches_jax(rng, vec_act):
    dims = dict(dim_vectors_in=V + 1, dim_vectors_out=V,
                dim_feats_in=S + 16, dim_feats_out=S,
                vectors_activation=vec_act)
    feats = rng.normal(size=(2, 5, 4, S + 16)).astype(np.float32)
    vecs = rng.normal(size=(2, 5, 4, V + 1, 3)).astype(np.float32)
    jmod = jgvp.GVP(**dims)
    params = jmod.init(jax.random.key(1), (feats, vecs))["params"]
    want = jmod.apply({"params": params}, (feats, vecs))
    tmod = tgvp.GVP(**dims)
    tmod.load_state_dict(gvp_state(flatten(params)))
    got = tmod((t(feats), t(vecs)))
    close(got[0], want[0], 2e-4)
    close(got[1], want[1], 2e-4)


def test_gvp_layer_norm_matches_jax(rng):
    feats = rng.normal(size=(3, 6, S)).astype(np.float32)
    vecs = rng.normal(size=(3, 6, V, 3)).astype(np.float32)
    vecs[0, 1] = 0.0
    jmod = jgvp.GVPLayerNorm(S)
    params = jmod.init(jax.random.key(0), feats, vecs)["params"]
    params = {"feat_norm": {
        "scale": rng.normal(size=S).astype(np.float32),
        "bias": rng.normal(size=S).astype(np.float32)}}
    want = jmod.apply({"params": params}, feats, vecs)
    tmod = tgvp.GVPLayerNorm(S)
    tmod.load_state_dict({"feat_norm.weight": t(params["feat_norm"]["scale"]),
                          "feat_norm.bias": t(params["feat_norm"]["bias"])})
    got = tmod(t(feats), t(vecs))
    close(got[0], want[0], 2e-4)
    close(got[1], want[1], 2e-4)


def test_reset_parameters_is_seeded_torch_default_init():
    a = tgvp.reset_parameters_(tgvp.GVP(4, 4, 8, 8),
                               torch.Generator().manual_seed(3))
    b = tgvp.reset_parameters_(tgvp.GVP(4, 4, 8, 8),
                               torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    w = a.to_feats_out[0].weight
    assert w.abs().max() <= 1.0 / np.sqrt(w.shape[1])


# ------------------------------------------------------------------- conv

def conv_inputs(rng, b=4, f=8, p=32, vectors_zero=True, tiled=False):
    """Node features and coordinates; `tiled` repeats one pocket (and its
    prot state) over every row."""
    pharm_x = rng.normal(scale=3.0, size=(b, f, 3)).astype(np.float32)
    pharm_mask = np.arange(f)[None] < rng.integers(3, f + 1, b)[:, None]
    n_rows = 1 if tiled else b
    prot_x = rng.normal(scale=3.0, size=(n_rows, p, 3)).astype(np.float32)
    prot_mask = np.arange(p)[None] < rng.integers(p - 8, p + 1,
                                                  n_rows)[:, None]
    prot_h = rng.normal(size=(n_rows, p, S)).astype(np.float32)
    prot_v = rng.normal(size=(n_rows, p, V, 3)).astype(np.float32)
    if tiled:
        prot_x, prot_mask, prot_h, prot_v = (
            np.repeat(a, b, axis=0) for a in (prot_x, prot_mask, prot_h,
                                              prot_v))
    pharm_h = rng.normal(size=(b, f, S)).astype(np.float32)
    pharm_v = rng.normal(size=(b, f, V, 3)).astype(np.float32)
    if vectors_zero:
        pharm_v[:] = 0.0
        prot_v[:] = 0.0
    pharm_h *= pharm_mask[..., None]
    prot_h *= prot_mask[..., None]
    return dict(pharm=(pharm_h, pharm_x, pharm_v),
                prot=(prot_h, prot_x, prot_v)), \
        dict(pharm=pharm_mask, prot=prot_mask)


def conv_state_dict(params, pruned: bool):
    """Flax conv params -> the port conv's state dict, through the port's
    key map for a one-conv model."""
    flat = flatten(params)
    pre = "dynamics.noise_predictor.conv_layers.0."
    sd = {}
    for tkey, (fkey, tr) in key_map(1, 2, 1, 1, pruned).items():
        if tkey.startswith(pre):
            arr = np.asarray(flat[fkey[len("conv_layers_0."):]])
            sd[tkey[len(pre):]] = t(arr.T.copy() if tr else arr)
    return sd


def run_convs(rng, message_norm, pf_k=4, ff_k=0, vectors_zero=True,
              update_ntypes=("pharm", "prot"), group=1):
    b = 4
    feats, masks = conv_inputs(rng, b=b, vectors_zero=vectors_zero,
                               tiled=group > 1)
    px, pm = feats["prot"][1], masks["prot"]
    # JAX side
    feats_j = {k: tuple(jnp.asarray(a) for a in v) for k, v in feats.items()}
    masks_j = {k: jnp.asarray(v) for k, v in masks.items()}
    if group > 1:
        _, ed = jedges.build_pp_edge(jnp.asarray(px[::group]),
                                     jnp.asarray(pm[::group]), 3.5, 16)
        pp_j = jedges.GroupedEdgeData(ed.mask, ed.idx, ed.x_dir, ed.d_rbf,
                                      copies=group)
    else:
        _, pp_j = jedges.build_pp_edge(jnp.asarray(px), jnp.asarray(pm),
                                       3.5, 16)
    bundle_j = jedges.build_edge_bundle(
        feats_j["pharm"][1], masks_j["pharm"], feats_j["prot"][1],
        masks_j["prot"], CUTOFFS, ff_k=ff_k, pf_k=pf_k, pp_nbrs=None,
        pp_edge=pp_j)
    jmod = jconv.GVPMultiEdgeConv(scalar_size=S, vector_size=V,
                                  n_message_gvps=2, n_update_gvps=1,
                                  message_norm=message_norm)
    kw = dict(update_ntypes=update_ntypes, src_vectors_zero=vectors_zero,
              pp_src_group_size=group)
    params = jmod.init(jax.random.key(2), feats_j, masks_j, bundle_j,
                       **kw)["params"]
    want = jmod.apply({"params": params}, feats_j, masks_j, bundle_j, **kw)
    # port
    feats_t = {k: tuple(t(a) for a in v) for k, v in feats.items()}
    masks_t = {k: t(v) for k, v in masks.items()}
    if group > 1:
        _, ed = tedges.build_pp_edge(t(px[::group]), t(pm[::group]), 3.5, 16)
        pp_t = tedges.GroupedEdgeData(ed.mask, ed.idx, ed.x_dir, ed.d_rbf,
                                      copies=group)
    else:
        _, pp_t = tedges.build_pp_edge(t(px), t(pm), 3.5, 16)
    bundle_t = tedges.build_edge_bundle(
        feats_t["pharm"][1], masks_t["pharm"], feats_t["prot"][1],
        masks_t["prot"], CUTOFFS, ff_k=ff_k, pf_k=pf_k, pp_edge=pp_t)
    tmod = tconv.GVPMultiEdgeConv(scalar_size=S, vector_size=V,
                                  n_message_gvps=2, n_update_gvps=1,
                                  message_norm=message_norm,
                                  update_ntypes=update_ntypes)
    tmod.load_state_dict(conv_state_dict(params,
                                         update_ntypes == ("pharm",)))
    with torch.no_grad():
        got = tmod(feats_t, masks_t, bundle_t,
                   src_vectors_zero=vectors_zero, pp_src_group_size=group)
    return got, want, (tmod, feats_t, masks_t, bundle_t, pp_t)


def assert_conv_close(got, want, atol=2e-4):
    for nt in ("pharm", "prot"):
        close(got[nt][0], want[nt][0], atol)
        close(got[nt][2], want[nt][2], atol)


@pytest.mark.parametrize("message_norm", [
    "mean", 10.0, (("pharm", 3.0), ("prot", 7.0)), 0])
def test_conv_message_norm_modes_match_jax(rng, message_norm):
    got, want, _ = run_convs(rng, message_norm, ff_k=3)
    assert_conv_close(got, want)


@pytest.mark.parametrize("pf_k", [0, 4])
def test_conv_with_source_vectors_matches_jax(rng, pf_k):
    """A later conv: nonzero source vectors; pf by radius or by knn."""
    got, want, _ = run_convs(rng, "mean", pf_k=pf_k, vectors_zero=False)
    assert_conv_close(got, want)


def test_last_conv_without_prot_tail_matches_jax(rng):
    got, want, (tmod, *_) = run_convs(rng, 0, vectors_zero=False,
                                      update_ntypes=("pharm",))
    assert_conv_close(got, want)
    assert not any(k.endswith("_prot") or ".prot." in k
                   for k in tmod.state_dict())


def test_grouped_pp_matches_jax_and_ungrouped(rng):
    got, want, (tmod, feats, masks, bundle, pp_g) = run_convs(
        rng, "mean", group=2)
    assert_conv_close(got, want)
    # the same conv with the pp messages computed once per copy
    bundle = dict(bundle, pp=pp_g.expand())
    with torch.no_grad():
        flat = tmod(feats, masks, bundle, src_vectors_zero=True,
                    pp_src_group_size=1)
    for nt in ("pharm", "prot"):
        close(got[nt][0], flat[nt][0].numpy(), 1e-5)
        close(got[nt][2], flat[nt][2].numpy(), 1e-5)


# --------------------------------------------------------------- dynamics

def dyn_config(**kw):
    base = dict(n_timesteps=100, vector_size=V, n_convs=2,
                n_hidden_scalars=S, n_message_gvps=2, n_update_gvps=1,
                n_noise_gvps=2, message_norm="mean", pp_k_max=16,
                precision=1e-5)
    base.update(kw)
    return JaxConfig(**base), DiffusionConfig(**base)


def dyn_batch(rng, b=4, f=8, p=32, tiled=False):
    from tests.conftest import make_complex_batch
    batch = make_complex_batch(rng, b=b, f=f, p=p, p_valid=(28, 20))
    if tiled:
        batch = batch.replace(**{k: np.repeat(getattr(batch, k)[:1], b, 0)
                                 for k in ("prot_x", "prot_h", "prot_mask")})
    return batch


@pytest.mark.parametrize("mode", ["knn", "radius", "knn_grouped"])
def test_dynamics_forward_matches_jax(rng, mode):
    kw = dict(pf_k=4, ff_k=3) if mode.startswith("knn") else {}
    jcfg, tcfg = dyn_config(**kw)
    group = 2 if mode == "knn_grouped" else 1
    batch = dyn_batch(rng, tiled=group > 1)
    jmodel = JaxDiffusion(jcfg)
    params = jax.device_get(jmodel.init_params(jax.random.key(4), batch))
    tv = np.linspace(0.1, 0.9, batch.batch_size).astype(np.float32)
    if group > 1:
        tv = np.repeat(tv[::group], group)
    j_px, j_pm = jnp.asarray(batch.prot_x), jnp.asarray(batch.prot_mask)
    pp_nbrs, pp_edge = jedges.build_pp_edge(j_px, j_pm, 3.5, 16)
    want = jmodel.dynamics.apply(
        {"params": params}, jnp.asarray(batch.pharm_h),
        jnp.asarray(batch.pharm_x), jnp.asarray(batch.pharm_mask),
        jnp.asarray(batch.prot_h), j_px, j_pm, jnp.asarray(tv), pp_nbrs,
        pp_edge=pp_edge, pocket_group_size=group)

    model = PharmacophoreDiffusion(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg))
    px, pm = t(batch.prot_x), t(batch.prot_mask)
    _, pp_t = tedges.build_pp_edge(px, pm, 3.5, 16)
    if group > 1:
        _, ed = tedges.build_pp_edge(px[::group], pm[::group], 3.5, 16)
        pp_t = tedges.GroupedEdgeData(ed.mask, ed.idx, ed.x_dir, ed.d_rbf,
                                      copies=group)
    with torch.no_grad():
        got = model.dynamics(
            t(batch.pharm_h), t(batch.pharm_x), t(batch.pharm_mask),
            t(batch.prot_h), px, pm, t(tv), pp_edge=pp_t,
            pocket_group_size=group)
    close(got[0], want[0], 1e-4)
    close(got[1], want[1], 1e-4)
    assert not got[0][~t(batch.pharm_mask)].any()


def test_state_dict_has_reference_layout():
    _, tcfg = dyn_config(pf_k=4)
    sd = PharmacophoreDiffusion(tcfg, device="cpu").state_dict()
    want = key_map(2, 2, 1, 2, True)
    assert set(sd) == set(want)
    assert "dynamics.noise_predictor.conv_layers.0.edge_message_fns." \
           "prot_pp_prot.1.Wh" in sd
