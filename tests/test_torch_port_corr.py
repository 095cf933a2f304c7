"""PyTorch/CUDA port: the JAX package's default sampling dataflow -- the
compact prot tail, the prot encoder once per pocket group, and the
pocket-copy correction of the second conv (`pp_k_out`) -- against the
JAX package and against the port's own full-width path, on the CPU.

Tolerances:
* the pp out-edge tables and the maximum out-degree: bit-equal to JAX's,
  overflow included;
* one deterministic denoiser forward with the compact tail: 2e-4 against
  JAX (the conv tolerance, tests/test_pp_fused.py:147); rtol 1e-5 /
  atol 1e-6 against the port's full-width forward
  (tests/test_compact_tail.py:55);
* the chain with the correction: 2e-3 against JAX (fused_pp="interpret",
  injected noise, fp32, T=3); 2e-4 against the port's chain without it
  (tests/test_pp_corr.py:135), duplicate dirty slots included;
* the first conv's clean state: bit-equal to each copy's state at every
  atom outside that copy's pf lists, fp32 and bf16 edge chains;
* the dev-shape chain (n_convs=2, grouped, encoder once per group) against
  the ungrouped full-width chain: 1e-4 (tests/test_compact_tail.py:76);
* a train-mode loss: bit-identical whichever way `compact_prot_tail` is
  set.
JAX matmuls run in full fp32 (tests/conftest.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.data.batch import PharmComplexBatch as JaxBatch
from pharmaforge_tpu.models import edges as jedges
from pharmaforge_tpu.models.diffusion import (
    DiffusionConfig as JaxConfig,
    PharmacophoreDiffusion as JaxDiffusion,
)
from pharmaforge_tpu.ops.neighbors import build_pp_neighbors
from pharmaforge_tpu.training import sampling as jsampling
from pharmaforge_tpu_torch.data.batch import PharmComplexBatch, tile_pocket
from pharmaforge_tpu_torch.interop import params_from_jax
from pharmaforge_tpu_torch.models import conv as tconv
from pharmaforge_tpu_torch.models import edges as tedges
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)
from pharmaforge_tpu_torch.training import sampling as tsampling
from tests.conftest import make_complex_batch


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------ out-edge tables

def pp_graph(seed, g=3, p=17, k=5):
    """A random pp graph on both sides from the same coordinates."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, p, 3)).astype(np.float32) * 2.0
    mask = rng.random((g, p)) > 0.15
    mask[:, 0] = True
    _, jed = jedges.build_pp_edge(jnp.asarray(x), jnp.asarray(mask), 3.5, k)
    _, ted = tedges.build_pp_edge(t(x), t(mask), 3.5, k)
    np.testing.assert_array_equal(ted.idx.numpy(), np.asarray(jed.idx))
    np.testing.assert_array_equal(ted.mask.numpy(), np.asarray(jed.mask))
    return jed, ted


@pytest.mark.parametrize("seed,g,p,k", [(0, 3, 17, 5), (1, 2, 12, 6),
                                        (2, 2, 23, 7), (3, 1, 40, 16)])
@pytest.mark.parametrize("extra", [2, 0, -1])
def test_out_edges_bit_equal_to_jax(seed, g, p, k, extra):
    """`k_out` above and at the maximum out-degree: JAX's tables; below
    it, where JAX drops the overflow, the port raises."""
    jed, ted = pp_graph(seed, g, p, k)
    degree = tedges.max_pp_out_degree(ted)
    assert degree == int(jedges.max_pp_out_degree(jed)) > 1
    k_out = degree + extra
    if extra < 0:
        with pytest.raises(ValueError, match="out-degree"):
            tedges.build_pp_out_edges(ted, k_out)
        return
    want = jedges.build_pp_out_edges(jed, k_out)
    eid, emask = tedges.build_pp_out_edges(ted, k_out)
    np.testing.assert_array_equal(emask.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(eid.numpy(), np.asarray(want[0]))


# ---------------------------------------------------------------- probe

def probe_kw(**kw):
    base = dict(n_timesteps=3, n_convs=4, vector_size=4,
                n_hidden_scalars=16, message_norm="mean", n_message_gvps=2,
                n_update_gvps=1, n_noise_gvps=2, pf_k=4, pp_k_max=8,
                fused_pp="interpret")
    base.update(kw)
    return base


@pytest.mark.parametrize("gate", [
    dict(n_convs=3), dict(pf_k=0), dict(message_norm=0),
    dict(fused_pp=False), dict(compact_prot_tail=False),
    dict(prune_dead_prot_tail=False), "env"])
def test_probe_returns_zero_where_the_correction_cannot_engage(
        monkeypatch, gate):
    rng = np.random.default_rng(0)
    px = rng.normal(scale=2.0, size=(2, 24, 3)).astype(np.float32)
    pm = np.ones((2, 24), bool)
    kw = probe_kw()
    if gate == "env":
        monkeypatch.setenv("PHARMAFORGE_PP_CORR", "0")
    else:
        kw.update(gate)
    model = PharmacophoreDiffusion(DiffusionConfig(**kw), device="cpu")
    assert tsampling.probe_pp_k_out(model, px, pm) == 0


@pytest.mark.parametrize("seed,scale", [(0, 2.0), (1, 1.0), (2, 0.6)])
def test_probe_matches_jax(monkeypatch, seed, scale):
    rng = np.random.default_rng(seed)
    px = rng.normal(scale=scale, size=(3, 40, 3)).astype(np.float32)
    pm = rng.random((3, 40)) > 0.1
    kw = probe_kw(pp_k_max=16)
    model = PharmacophoreDiffusion(DiffusionConfig(**kw), device="cpu")
    got = tsampling.probe_pp_k_out(model, px, pm)
    # the JAX probe engages off the TPU only when forced
    monkeypatch.setenv("PHARMAFORGE_PP_CORR", "force")
    want = jsampling.probe_pp_k_out(JaxDiffusion(JaxConfig(**kw)), px, pm)
    assert got == want > 0 and got % 8 == 0


def test_sampler_probes_grouped_batches_only():
    rng = np.random.default_rng(1)
    model = PharmacophoreDiffusion(DiffusionConfig(**probe_kw()),
                                   device="cpu")
    sampler = tsampling.PocketSampler(model, device="cpu")
    px = rng.normal(scale=3.0, size=(28, 3)).astype(np.float32)
    ph = np.eye(11, dtype=np.float32)[rng.integers(0, 11, 28)]
    batch = tile_pocket(px, ph, [3, 5, 8])
    want = tsampling.probe_pp_k_out(model, batch.prot_x[:1],
                                    batch.prot_mask[:1])
    assert want > 0
    assert sampler._pp_k_out(batch, 3) == want
    assert sampler._pp_k_out(batch, 1) == 0


# ---------------------------------------------------- compact forward

def compact_kw(**kw):
    base = dict(n_timesteps=6, n_convs=2, vector_size=8,
                n_hidden_scalars=32, message_norm="mean", n_message_gvps=2,
                n_update_gvps=1, n_noise_gvps=2, pf_k=4, pp_k_max=8)
    base.update(kw)
    return base


@pytest.mark.parametrize("message_norm,n_convs", [
    ("mean", 2), (0, 2), (10, 2), ("mean", 3)])
def test_compact_forward_matches_jax_and_full_width(rng, message_norm,
                                                    n_convs):
    batch = make_complex_batch(rng, b=3, p=40, f_valid=(5, 3, 8),
                               p_valid=(36, 28, 40))
    kw = compact_kw(message_norm=message_norm, n_convs=n_convs)
    jmodel = JaxDiffusion(JaxConfig(**kw))
    params = jax.device_get(jmodel.init_params(jax.random.key(0), batch))
    tv = np.float32([0.3, 0.7, 0.1])
    pp = build_pp_neighbors(jnp.asarray(batch.prot_x),
                            jnp.asarray(batch.prot_mask), 3.5, 8)
    want = jmodel.dynamics.apply(
        {"params": params}, jnp.asarray(batch.pharm_h),
        jnp.asarray(batch.pharm_x), jnp.asarray(batch.pharm_mask),
        jnp.asarray(batch.prot_h), jnp.asarray(batch.prot_x),
        jnp.asarray(batch.prot_mask), jnp.asarray(tv), pp,
        deterministic=True)
    px, pm = t(batch.prot_x), t(batch.prot_mask)
    _, pp_t = tedges.build_pp_edge(px, pm, 3.5, 8)
    args = (t(batch.pharm_h), t(batch.pharm_x), t(batch.pharm_mask),
            t(batch.prot_h), px, pm, t(tv))
    outs = {}
    for on in (True, False):
        cfg = DiffusionConfig(**kw, compact_prot_tail=on)
        model = PharmacophoreDiffusion(cfg, device="cpu")
        model.load_state_dict(params_from_jax(params, cfg))
        with torch.no_grad():
            outs[on] = model.dynamics(*args, pp_edge=pp_t)
    for got, full, w in zip(outs[True], outs[False], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("fault,match", [
    ("train", "eval mode"), ("ungrouped", "grouped, non-compact"),
    ("dynamic norm", "non-dynamic")])
def test_emit_clean_prot_keeps_the_jax_checks(rng, monkeypatch, fault,
                                              match):
    """The first conv of the correction, called again on its own inputs
    in train mode, on a per-copy pp edge or with a dynamic norm, raises
    as the JAX conv does (conv.py:862-957)."""
    copies = 3
    batch = grouped_batch(rng, copies=copies)
    model = PharmacophoreDiffusion(
        DiffusionConfig(**probe_kw(n_timesteps=1)), device="cpu",
        generator=torch.Generator().manual_seed(2))
    seen = []
    real = tconv.GVPMultiEdgeConv.forward

    def spy(self, node_feats, node_masks, bundle, **kw):
        if kw.get("emit_clean_prot"):
            seen.append((self, node_feats, node_masks, bundle, dict(kw)))
        return real(self, node_feats, node_masks, bundle, **kw)

    monkeypatch.setattr(tconv.GVPMultiEdgeConv, "forward", spy)
    model.sample_given_receptor(batch, noise=chain_noise(rng, batch, 1),
                                pocket_group_size=copies, pp_k_out=16)
    assert len(seen) == 1
    conv, node_feats, node_masks, bundle, kw = seen[0]
    real(conv, node_feats, node_masks, bundle, **kw)
    if fault == "train":
        conv.train()
    elif fault == "ungrouped":
        kw["pp_src_group_size"] = 1
    else:
        monkeypatch.setitem(conv.norm_values, "prot", 0.0)
    with pytest.raises(ValueError, match=match), torch.no_grad():
        real(conv, node_feats, node_masks, bundle, **kw)


# ------------------------------------------------------ the correction

def grouped_batch(rng, copies=3, g=2, p=24, scale=1.0):
    """`g` pockets x `copies` rows (pocket-major); `scale` shrinks the
    pockets (denser pp graphs)."""
    batch = make_complex_batch(rng, b=g * copies, p=p,
                               f_valid=(4, 4, 4, 6, 6, 6),
                               p_valid=(p - 4,) * copies + (p,) * copies)

    def rep(a):
        return np.repeat(a[::copies], copies, axis=0)

    batch = PharmComplexBatch(
        pharm_x=batch.pharm_x, pharm_h=batch.pharm_h,
        pharm_mask=batch.pharm_mask, prot_x=rep(batch.prot_x) * scale,
        prot_h=rep(batch.prot_h), prot_mask=rep(batch.prot_mask))
    return batch


def chain_noise(rng, batch, steps):
    b, f = batch.pharm_mask.shape
    noise = {"x_T": rng.normal(size=(b, f, 3)),
             "h_T": rng.normal(size=(b, f, 6)),
             "pos": rng.normal(size=(steps, b, f, 3)),
             "feat": rng.normal(size=(steps, b, f, 6))}
    return {k: v.astype(np.float32) for k, v in noise.items()}


def count_corrections(monkeypatch) -> list:
    """Records the copies of every `_fused_pp_corrected` call."""
    calls = []
    real = tconv.GVPMultiEdgeConv._fused_pp_corrected

    def spy(self, *args):
        calls.append(args[4])
        return real(self, *args)

    monkeypatch.setattr(tconv.GVPMultiEdgeConv, "_fused_pp_corrected", spy)
    return calls


def test_correction_chain_matches_jax_and_the_plain_path(rng, monkeypatch):
    """The probed k_out, the JAX chain through its interpreted kernel with
    the correction, the port's chain with and without it."""
    copies, steps = 3, 3
    batch = grouped_batch(rng, copies=copies)
    kw = probe_kw(n_timesteps=steps)
    jbatch = JaxBatch(**dataclasses.asdict(batch))
    jmodel = JaxDiffusion(JaxConfig(**kw))
    params = jax.device_get(jmodel.init_params(jax.random.key(0), jbatch))
    cfg = DiffusionConfig(**kw)
    model = PharmacophoreDiffusion(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    k_out = tsampling.probe_pp_k_out(model, batch.prot_x[::copies],
                                     batch.prot_mask[::copies])
    assert k_out > 0
    noise = chain_noise(rng, batch, steps)
    com = rng.normal(size=(batch.batch_size, 3)).astype(np.float32)
    run = dict(init_pharm_com=com, noise=noise, pocket_group_size=copies)
    want = jmodel.sample_given_receptor(params, jbatch, jax.random.key(0),
                                        pp_k_out=k_out, **run)
    calls = count_corrections(monkeypatch)
    got = model.sample_given_receptor(batch, pp_k_out=k_out, **run)
    assert calls == [copies] * steps
    plain = model.sample_given_receptor(batch, pp_k_out=0, **run)
    assert len(calls) == steps
    for key in ("pharm_x", "pharm_h"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=2e-3, rtol=0, err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), plain[key].numpy(),
                                   atol=2e-4, rtol=0, err_msg=key)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_correction_with_duplicate_dirty_slots(rng, monkeypatch,
                                               compute_dtype):
    """Pharm centres sharing pf neighbours (a 12-atom pocket, pf_k=8):
    each shared atom's out-edges are corrected once."""
    copies = 2
    batch = grouped_batch(rng, copies=copies, p=12, scale=0.4)
    kw = probe_kw(n_timesteps=2, pf_k=8, pp_k_max=6,
                  compute_dtype=compute_dtype)
    model = PharmacophoreDiffusion(
        DiffusionConfig(**kw), device="cpu",
        generator=torch.Generator().manual_seed(1))
    noise = chain_noise(rng, batch, 2)
    calls = count_corrections(monkeypatch)
    run = dict(noise=noise, pocket_group_size=copies)
    got = model.sample_given_receptor(batch, pp_k_out=16, **run)
    plain = model.sample_given_receptor(batch, pp_k_out=0, **run)
    assert calls == [copies] * 2
    for key in ("pharm_x", "pharm_h"):
        np.testing.assert_allclose(got[key].numpy(), plain[key].numpy(),
                                   atol=2e-4, rtol=0, err_msg=key)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_clean_state_equals_each_copy_outside_the_pf_lists(
        rng, monkeypatch, compute_dtype):
    """The correction's premise: the first conv's per-copy prot state
    equals its group-level clean state, bit for bit, at every atom that
    no pf list of that copy references."""
    copies = 3
    batch = grouped_batch(rng, copies=copies)
    model = PharmacophoreDiffusion(
        DiffusionConfig(**probe_kw(n_timesteps=1,
                                   compute_dtype=compute_dtype)),
        device="cpu", generator=torch.Generator().manual_seed(2))
    seen = []
    real = tconv.GVPMultiEdgeConv.forward

    def spy(self, node_feats, node_masks, bundle, **kw):
        res = real(self, node_feats, node_masks, bundle, **kw)
        if kw.get("emit_clean_prot"):
            seen.append((res, bundle["pf"]))
        return res

    monkeypatch.setattr(tconv.GVPMultiEdgeConv, "forward", spy)
    model.sample_given_receptor(batch, noise=chain_noise(rng, batch, 1),
                                pocket_group_size=copies, pp_k_out=16)
    assert len(seen) == 1
    (out, (clean_h, clean_v)), pf = seen[0]
    h, _, v = out["prot"]
    n_clean = 0
    for b in range(h.shape[0]):
        dirty = set(pf.idx[b][pf.mask[b]].tolist())
        keep = [a for a in range(h.shape[1]) if a not in dirty]
        n_clean += len(keep)
        assert torch.equal(h[b, keep], clean_h[b // copies, keep]), b
        assert torch.equal(v[b, keep], clean_v[b // copies, keep]), b
        assert not torch.equal(h[b], clean_h[b // copies])
    assert n_clean > h.shape[0] * (h.shape[1] // 2)


# --------------------------------------------------- dev shape, training

def test_dev_shape_grouped_chain_matches_ungrouped_full_width(rng):
    """n_convs=2: the first conv is the compact one, so the prot encoder
    runs once per pocket group and the first conv reads group-level prot
    state; against the ungrouped chain with the compact tail off."""
    prot_x = rng.normal(scale=6.0, size=(40, 3)).astype(np.float32)
    prot_h = np.eye(11, dtype=np.float32)[rng.integers(0, 11, 40)]
    batch = tile_pocket(prot_x, prot_h, rng.integers(3, 9, 6))
    kw = compact_kw()
    on = PharmacophoreDiffusion(DiffusionConfig(**kw), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    off = PharmacophoreDiffusion(
        DiffusionConfig(**kw, compact_prot_tail=False), device="cpu")
    off.load_state_dict(on.state_dict())
    run = dict(noise=chain_noise(rng, batch, kw["n_timesteps"]))
    seen = []
    real = on.dynamics.prot_encoder.forward
    on.dynamics.prot_encoder.forward = lambda x: seen.append(x.shape[0]) \
        or real(x)
    got = on.sample_given_receptor(batch, pocket_group_size=6, **run)
    want = off.sample_given_receptor(batch, pocket_group_size=1, **run)
    assert seen == [1] * kw["n_timesteps"]       # one pocket group
    for key in ("pharm_x", "pharm_h"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_train_loss_is_unaffected_by_the_compact_flag(rng):
    """The compact tail is eval-mode only: a train-mode loss with dropout
    is bit-identical whichever way the flag is set."""
    batch = make_complex_batch(rng, b=2, p=32, p_valid=(28, 24))
    batch = PharmComplexBatch(**{f.name: getattr(batch, f.name) for f in
                                 dataclasses.fields(PharmComplexBatch)})
    kw = compact_kw(dropout=0.1)
    losses = []
    state = None
    for on in (True, False):
        model = PharmacophoreDiffusion(
            DiffusionConfig(**kw, compact_prot_tail=on), device="cpu",
            generator=torch.Generator().manual_seed(0))
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        total, _ = model.loss(batch, torch.Generator().manual_seed(3),
                              train=True)
        losses.append(total.item())
    assert losses[0] == losses[1]
