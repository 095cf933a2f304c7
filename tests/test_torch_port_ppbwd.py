"""PyTorch/CUDA port, slice 3: the backward of the fused prot-prot message
chain (K3's plain version and the autograd wiring of
`pharmaforge_tpu_torch.ops.pp_message`) against the JAX package on the CPU.

The same numpy inputs (seeded) go through `jax.grad` of the JAX package's
fused function (its Pallas backward kernel in interpret mode) and of its
jnp twin, and through autograd of the port's plain version, at the shapes
of tests/test_pp_fused.py:281-321. Every gradient leaf must agree within
rtol 2e-4 / atol 2e-5, the JAX kernel-vs-twin tolerance there. JAX matmuls
run in full fp32 (tests/conftest.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.ops.pallas import pp_message as jppm
from pharmaforge_tpu_torch.ops import pp_message as ppm
from pharmaforge_tpu_torch.utils import trace
from tests.test_torch_port_pp import jax_side, k2_case, port_edge, port_gvps, t

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _jax_loss(fn, edge, kw):
    def loss(args):
        pre, planes, layers = args
        s_a, v_a = fn(pre, planes, edge, layers, **kw)
        return jnp.sum(s_a ** 2) + jnp.sum(jnp.sin(v_a))
    return loss


def _port_grads(c, fn, **kw):
    """Autograd of the same loss through `fn` w.r.t. pre_s, the planes and
    every GVP parameter, as numpy in the JAX layout: (pre_s, planes,
    [(wh, wu, (w1, b1), (wg, bg)), ...])."""
    pre_s = t(c["pre_s"]).requires_grad_(True)
    planes = [t(q).requires_grad_(True) for q in c["planes"]]
    gvps = port_gvps(c)
    s_a, v_a = fn(pre_s, planes, port_edge(c), gvps, scalar_size=c["s"],
                  vector_size=c["v"], rbf_dim=c["r"], copies=c["copies"],
                  **kw)
    (torch.sum(s_a ** 2) + torch.sum(torch.sin(v_a))).backward()
    layers = []
    for m in gvps:
        lin, gates = m.to_feats_out[0], m.scalar_to_vector_gates
        layers.append((m.Wh.grad.numpy(), m.Wu.grad.numpy(),
                       (lin.weight.grad.numpy().T, lin.bias.grad.numpy()),
                       (gates.weight.grad.numpy().T, gates.bias.grad.numpy())))
    return (pre_s.grad.numpy(), [q.grad.numpy() for q in planes], layers)


@pytest.mark.parametrize("n_gvps", [3, 5])
@pytest.mark.parametrize("copies", [1, 3])
def test_plain_backward_matches_jax_pallas_backward_and_twin(rng, copies,
                                                            n_gvps):
    c = k2_case(rng, copies=copies, hj=5,           # later GVPs: hidden V+1
                n_gvps=n_gvps)
    kw = dict(scalar_size=c["s"], vector_size=c["v"], rbf_dim=c["r"],
              copies=copies)
    j_pre, j_planes, j_edge, j_layers = jax_side(c)
    args = (j_pre, tuple(j_planes), j_layers)
    assert jppm.bwd_kernel_enabled()
    g_kernel = jax.grad(_jax_loss(
        lambda *a, **k: jppm.fused_message_agg(*a, interpret=True, **k),
        j_edge, kw))(args)
    g_twin = jax.grad(_jax_loss(jppm.message_agg_reference, j_edge, kw))(
        args)
    got = _port_grads(c, ppm.message_agg_reference)
    flat_got = jax.tree_util.tree_leaves(got)
    for want in (g_kernel, g_twin):
        flat_want = jax.tree_util.tree_leaves(want)
        assert len(flat_got) == len(flat_want) == 4 + 6 * n_gvps
        for i, (a, b) in enumerate(zip(flat_got, flat_want)):
            np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL,
                                       err_msg=f"grad leaf {i}")


@pytest.mark.parametrize("copies", [1, 3])
def test_float64_plain_version_matches_jax_twin(rng, copies):
    """The plain version run in fp64 (the reference K3's fp32 gradients are
    held to on the card) is the same function: fp64 sums, and gradients
    within the fp32 tolerance of `jax.grad` through the JAX twin."""
    c = k2_case(rng, copies=copies, hj=5)
    kw = dict(scalar_size=c["s"], vector_size=c["v"], rbf_dim=c["r"],
              copies=copies)
    j_pre, j_planes, j_edge, j_layers = jax_side(c)
    want = jax.grad(_jax_loss(jppm.message_agg_reference, j_edge, kw))(
        (j_pre, tuple(j_planes), j_layers))
    s_a, v_a = ppm.message_agg_reference(
        t(c["pre_s"]), [t(q) for q in c["planes"]], port_edge(c),
        port_gvps(c), compute_dtype="float64", **kw)
    assert s_a.dtype == v_a.dtype == torch.float64
    got = _port_grads(c, ppm.message_agg_reference, compute_dtype="float64")
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want) == 4 + 6 * 3
    for i, (a, b) in enumerate(zip(flat_got, flat_want)):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL,
                                   err_msg=f"grad leaf {i}")


def test_wrapper_is_differentiable_on_cpu(rng):
    """On CPU tensors the wrapper is the plain version, so autograd through
    it gives the plain version's gradients exactly, and no kernel runs."""
    c = k2_case(rng, copies=3, hj=5)
    before = trace.counters()
    got = _port_grads(c, ppm.fused_message_agg)
    want = _port_grads(c, ppm.message_agg_reference)
    after = trace.counters()
    for name in ("pp_message.launches", "pp_message.bwd_launches"):
        assert after[name] == before[name]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("field", ["x_dir", "d_rbf"])
def test_geometry_gradient_raises(rng, field):
    c = k2_case(rng)
    edge = port_edge(c)
    edge = edge._replace(**{field: getattr(edge, field).requires_grad_(True)})
    with pytest.raises(RuntimeError, match="geometry"):
        ppm.fused_message_agg(t(c["pre_s"]), [t(q) for q in c["planes"]],
                              edge, port_gvps(c), scalar_size=c["s"],
                              vector_size=c["v"], rbf_dim=c["r"])


def test_kernel_function_routes_gradients_to_the_parameters(rng,
                                                            monkeypatch):
    """The autograd Function that drives K2/K3 on the card, run on CPU
    tensors with the two launches replaced by plain stand-ins that honour
    the kernels' contracts (K3: fp32 node-table grads and the weight grads
    flattened in `split_weights` order, fp64): the parameters' gradients
    must be those of autograd through the plain version."""
    c = k2_case(rng, copies=3, hj=5)
    kw = dict(scalar_size=c["s"], vector_size=c["v"], rbf_dim=c["r"],
              copies=3, compute_dtype="float32")
    gvps_ref = port_gvps(c)
    weights_ref = [w.detach().requires_grad_(True)
                   for w in ppm.split_weights(gvps_ref, c["s"], c["r"])]
    edge = port_edge(c)

    def plain_fwd(d, tab_s, tab_v, idx, mask, rterm, dirterm, packed):
        with torch.no_grad():
            return ppm.message_agg_reference(
                tab_s, tab_v.unbind(2), edge, gvps_ref, **kw)

    def plain_bwd(d, saved, ds, dv):
        tab_s = saved[0].detach().requires_grad_(True)
        tab_v = saved[1].detach().requires_grad_(True)
        with torch.enable_grad():
            rterm, dirterm = ppm._edge_terms(weights_ref, edge.x_dir,
                                             edge.d_rbf, torch.float32)
            out = ppm._chain_plain(tab_s, tab_v, edge.idx, edge.mask, rterm,
                                   dirterm, weights_ref, torch.float32, 3)
            grads = torch.autograd.grad(out, [tab_s, tab_v, *weights_ref],
                                        (ds, dv))
        return grads[0], grads[1], torch.cat([g.reshape(-1)
                                              for g in grads[2:]]).double()

    monkeypatch.setattr(ppm, "_launch_fwd", plain_fwd)
    monkeypatch.setattr(ppm, "_launch_bwd", plain_bwd)
    pre_s = t(c["pre_s"]).requires_grad_(True)
    planes = [t(q).requires_grad_(True) for q in c["planes"]]
    gvps = port_gvps(c)
    weights = ppm.split_weights(gvps, c["s"], c["r"])
    d = ppm._dims(pre_s, planes, edge, weights, **kw)
    s_a, v_a = ppm._FusedMessageAgg.apply(d, edge, pre_s, *planes, *weights)
    (torch.sum(s_a ** 2) + torch.sum(torch.sin(v_a))).backward()
    want = _port_grads(c, ppm.message_agg_reference)
    np.testing.assert_allclose(pre_s.grad.numpy(), want[0], rtol=1e-5,
                               atol=1e-6)
    for q, w in zip(planes, want[1]):
        np.testing.assert_allclose(q.grad.numpy(), w, rtol=1e-5, atol=1e-6)
    for m, (wh, wu, (w1, b1), (wg, bg)) in zip(gvps, want[2]):
        lin, gates = m.to_feats_out[0], m.scalar_to_vector_gates
        for got, exp in ((m.Wh.grad, wh), (m.Wu.grad, wu),
                         (lin.weight.grad.T, w1), (lin.bias.grad, b1),
                         (gates.weight.grad.T, wg), (gates.bias.grad, bg)):
            np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5,
                                       atol=1e-6)
