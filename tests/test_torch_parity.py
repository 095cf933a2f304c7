"""Numerical parity between the flax GVP stack and a torch execution of the
same weights through the exported (reference-layout) state dict.

This validates the interop conventions end-to-end: if the exported tensors
load into torch modules with the reference's layouts (Linear [out, in],
Wh/Wu [in, out]) and produce the same numbers, then real reference
checkpoints will too. The torch modules below implement this framework's
documented GVP math (models/gvp.py) — einsum core, norm clamping, vector
gating — using the exported tensors verbatim.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.models.gvp import GVP


def torch_gvp_forward(state, prefix, feats, vectors):
    """Run one GVP in torch from reference-layout tensors.

    state maps reference-style keys (Wh, Wu, to_feats_out.0.weight [out,in],
    scalar_to_vector_gates.weight [out,in]) to numpy arrays.
    """
    wh = torch.from_numpy(state[f"{prefix}Wh"])                  # [v_in, h]
    wu = torch.from_numpy(state[f"{prefix}Wu"])                  # [h, v_out]
    w1 = torch.from_numpy(state[f"{prefix}to_feats_out.0.weight"])
    b1 = torch.from_numpy(state[f"{prefix}to_feats_out.0.bias"])
    wg = torch.from_numpy(state[f"{prefix}scalar_to_vector_gates.weight"])
    bg = torch.from_numpy(state[f"{prefix}scalar_to_vector_gates.bias"])

    feats = torch.from_numpy(feats)
    vectors = torch.from_numpy(vectors)

    vh = torch.einsum("bvc,vh->bhc", vectors, wh)
    vu = torch.einsum("bhc,hu->buc", vh, wu)
    sh = torch.sqrt(torch.clamp(torch.sum(vh ** 2, dim=-1), min=1e-8))
    s = torch.cat([feats, sh], dim=-1)
    feats_out = torch.nn.functional.silu(
        torch.nn.functional.linear(s, w1, b1))
    gates = torch.nn.functional.linear(feats_out, wg, bg)
    vectors_out = torch.sigmoid(gates).unsqueeze(-1) * vu
    return feats_out.numpy(), vectors_out.numpy()


def test_gvp_torch_roundtrip_parity(rng):
    """flax GVP forward == torch forward through exported tensors."""
    gvp = GVP(dim_vectors_in=6, dim_vectors_out=5, dim_feats_in=9,
              dim_feats_out=7)
    feats = rng.normal(size=(11, 9)).astype(np.float32)
    vectors = rng.normal(size=(11, 6, 3)).astype(np.float32)
    params = jax.device_get(gvp.init(
        jax.random.key(0), (jnp.asarray(feats), jnp.asarray(vectors))))
    s_jax, v_jax = gvp.apply(params, (jnp.asarray(feats),
                                      jnp.asarray(vectors)))

    p = params["params"]
    state = {
        "Wh": np.asarray(p["Wh"]),
        "Wu": np.asarray(p["Wu"]),
        # torch Linear stores [out, in]
        "to_feats_out.0.weight": np.asarray(p["to_feats_out"]["kernel"]).T,
        "to_feats_out.0.bias": np.asarray(p["to_feats_out"]["bias"]),
        "scalar_to_vector_gates.weight":
            np.asarray(p["scalar_to_vector_gates"]["kernel"]).T,
        "scalar_to_vector_gates.bias":
            np.asarray(p["scalar_to_vector_gates"]["bias"]),
    }
    s_t, v_t = torch_gvp_forward(state, "", feats, vectors)
    np.testing.assert_allclose(np.asarray(s_jax), s_t, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(v_jax), v_t, atol=2e-5, rtol=2e-5)


def test_exported_state_dict_torch_parity(rng):
    """Full-model export: the noise head GVPs run identically in torch when
    loaded from export_torch_state_dict output."""
    from pharmaforge_tpu.interop.torch_import import export_torch_state_dict
    from pharmaforge_tpu.models.diffusion import PharmacophoreDiffusion
    from tests.conftest import make_complex_batch
    from tests.test_diffusion import tiny_config

    batch = make_complex_batch(rng, p=24, p_valid=(20, 16))
    cfg = tiny_config(n_convs=1)
    model = PharmacophoreDiffusion(cfg)
    params = jax.device_get(model.init_params(jax.random.key(2), batch))
    state = export_torch_state_dict(params, cfg)

    feats = rng.normal(size=(5, cfg.n_hidden_scalars)).astype(np.float32)
    vectors = rng.normal(size=(5, cfg.vector_size, 3)).astype(np.float32)

    # torch pass through the head's first GVP
    prefix = "dynamics.noise_predictor.noise_predictor.gvps.0."
    s_t, v_t = torch_gvp_forward(state, prefix, feats, vectors)

    # flax pass with the same sub-tree
    head = GVP(dim_vectors_in=cfg.vector_size,
               dim_vectors_out=cfg.vector_size,
               dim_feats_in=cfg.n_hidden_scalars,
               dim_feats_out=cfg.n_hidden_scalars)
    sub = params["noise_predictor"]["gvps"]["layers_0"]
    s_jax, v_jax = head.apply({"params": sub},
                              (jnp.asarray(feats), jnp.asarray(vectors)))
    np.testing.assert_allclose(np.asarray(s_jax), s_t, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(v_jax), v_t, atol=2e-5, rtol=2e-5)
