"""PyTorch/CUDA port, the multi-step train call (`training/train_state.py::
multi_train_step`, the counterpart of JAX `make_multi_train_step`) and the
trainer's chunk path, on the CPU.

* K=3 steps in one call against 3 single `train_step` calls from the same
  weights, optimizer and generator state, at dropout 0.1: bit-equal
  weights, optimizer state, generator state and metrics (as
  tests/test_multi_step.py:32-60 holds the JAX call);
* the port's call against JAX's `make_multi_train_step` with JAX's own
  per-step draws injected, dropout 0, accumulate 1 and 2: losses within
  rtol 1e-5, each weight leaf within 2e-4 max|b| + 2e-5 after 3 steps
  (the train-step tolerance of test_torch_port_train.py);
* the runner (`TrainGraphs`: warm-up, capture, input copies, the
  accumulation phase, kept graphs) with the stand-in for CUDA graphs of
  tests/recorded_graphs.py, which records a capture's body and replays
  it: bit-equal to the eager calls; the real graphs run in the card tests
  (test_torch_port_cuda.py);
* `Trainer.fit` at `steps_per_call: 3` over two prot buckets follows the
  JAX trainer's chunk rule (trainer.py:344-393): calls grouped per padded
  shape with leftovers single at the epoch's end, validation and sampling
  only on the state after a call, one learning rate a call with a plateau
  cut taking effect at the next call; every batch one step and one metrics
  row, and the loss drops (tests/test_trainer_chunked.py's checks).
JAX matmuls run in full fp32 (tests/conftest.py).
"""

import json

import numpy as np
import jax
import optax
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu.data.batch import stack_batches as jax_stack
from pharmaforge_tpu.models.diffusion import (
    DiffusionConfig as JaxConfig,
    PharmacophoreDiffusion as JaxDiffusion,
)
from pharmaforge_tpu.training import optim as joptim
from pharmaforge_tpu.training.train_state import (
    TrainState,
    make_multi_train_step,
)
from pharmaforge_tpu_torch.config.load_from_config import (
    data_module_from_config,
    model_from_config,
)
from pharmaforge_tpu_torch.data import batch as tbatch
from pharmaforge_tpu_torch.data.batch import pad_batch_to_multiple
from pharmaforge_tpu_torch.data.synthetic import (
    make_synthetic_processed_dataset,
)
from pharmaforge_tpu_torch.interop import params_from_jax
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)
from pharmaforge_tpu_torch.training.optim import Adam
from pharmaforge_tpu_torch.training.train_state import (
    multi_train_step,
    train_step,
)
from pharmaforge_tpu_torch.training.trainer import Trainer
from pharmaforge_tpu_torch.utils import trace
from tests.conftest import make_complex_batch
from tests.recorded_graphs import RecordedGraph, recorded_graphs
from tests.test_torch_port_train import (
    ELEMENTS,
    PH_TYPES,
    CUTOFFS,
    grad_close,
    port_batch,
)

K = 3


def small_kw(**kw):
    base = dict(n_timesteps=20, vector_size=4, n_convs=3,
                n_hidden_scalars=16, n_message_gvps=3, n_update_gvps=2,
                n_noise_gvps=3, message_norm="mean", pf_k=4, pp_k_max=8,
                dropout=0.0, precision=1e-4, endpoint_param_feat=True,
                endpoint_param_coord=True)
    base.update(kw)
    return base


def jax_batches(n=K, seed=100):
    """`n` same-shape JAX batches of 3 pockets in 40 slots (pp edges at
    3.5 A)."""
    out = []
    for i in range(n):
        jb = make_complex_batch(np.random.default_rng(seed + i), b=3, p=40,
                                f_valid=(5, 3, 7), p_valid=(36, 30, 40))
        out.append(jb.replace(prot_x=jb.prot_x * 0.4))
    return out


def port_model(seed=0, **kw):
    return PharmacophoreDiffusion(
        DiffusionConfig(**small_kw(**kw)), device="cpu",
        generator=torch.Generator().manual_seed(seed))


def clone_setup(model, accumulate=1, gen_seed=5):
    """A copy of `model` with a fresh optimizer and generator."""
    m = PharmacophoreDiffusion(model.config, device="cpu")
    m.load_state_dict(model.state_dict())
    opt = Adam(m.parameters(), 2e-3, weight_decay=1e-12, clip_value=0.5,
               accumulate=accumulate)
    return m, opt, torch.Generator().manual_seed(gen_seed)


def assert_same_state(a, b):
    """Bit-equal weights, Adam state, accumulation state and generator."""
    (ma, oa, ga), (mb, ob, gb) = a, b
    for (name, x), y in zip(ma.state_dict().items(),
                            mb.state_dict().values()):
        assert torch.equal(x, y), name
    for p, q in zip(oa.params, ob.params):
        for key, x in oa.opt.state[p].items():
            assert torch.equal(x, ob.opt.state[q][key]), key
    assert oa.mini_step == ob.mini_step
    for x, y in zip(oa._acc, ob._acc):
        assert torch.equal(x, y)
    assert torch.equal(ga.get_state(), gb.get_state())


# ------------------------------------------------- K steps against K singles

@pytest.mark.parametrize("accumulate", [1, 2])
def test_multi_step_matches_sequential(accumulate):
    batches = [port_batch(b) for b in jax_batches()]
    base = port_model(dropout=0.1)
    seq, multi = clone_setup(base, accumulate), clone_setup(base, accumulate)
    want = [train_step(*seq[:2], b, seq[2], 2e-3) for b in batches]
    got = multi_train_step(*multi[:2], tbatch.stack_batches(batches),
                           multi[2], 2e-3)
    assert_same_state(seq, multi)
    assert set(got) == set(want[0])
    for key, vals in got.items():
        assert vals.shape == (K,)
        assert vals.tolist() == [w[key] for w in want], key
    # the steps moved the weights and drew from the generator
    assert not torch.equal(next(seq[0].parameters()),
                           next(base.parameters()))
    assert not torch.equal(seq[2].get_state(),
                           torch.Generator().manual_seed(5).get_state())


# ---------------------------------------------------------- against JAX

@pytest.mark.parametrize("accumulate", [1, 2])
def test_multi_step_matches_jax(accumulate):
    kw = small_kw()
    jbs = jax_batches()
    jmodel = JaxDiffusion(JaxConfig(fused_pp=False, **kw))
    params = jmodel.init_params(jax.random.key(1), jbs[0])
    opt = joptim.make_optimizer(2e-3, weight_decay=1e-12, clip_value=0.5)
    if accumulate > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accumulate)
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=np.int32(0))
    call_key = jax.random.key(9)
    state_after, j_aux = make_multi_train_step(jmodel, opt, donate=False)(
        state, jax_stack(jbs), call_key, 2e-3)
    # each step key's draws, as JAX's loss makes them
    b, f = jbs[0].pharm_mask.shape
    noise = []
    for step_key in jax.random.split(call_key, K):
        k_t, k_ex, k_eh, _ = jax.random.split(step_key, 4)
        noise.append({
            "t_int": np.asarray(jax.random.randint(k_t, (b,), 0, 20)),
            "eps_x": np.asarray(jax.random.normal(k_ex, (b, f, 3))),
            "eps_h": np.asarray(jax.random.normal(k_eh, (b, f, 6)))})

    cfg = DiffusionConfig(**kw)
    model = PharmacophoreDiffusion(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), cfg))
    adam = Adam(model.parameters(), 2e-3, weight_decay=1e-12,
                clip_value=0.5, accumulate=accumulate)
    got = multi_train_step(model, adam,
                           tbatch.stack_batches([port_batch(x)
                                                 for x in jbs]),
                           None, 2e-3, noise=noise)
    assert set(got) == set(j_aux)
    for key, vals in got.items():
        np.testing.assert_allclose(vals, np.asarray(j_aux[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    assert adam.mini_step == K % accumulate
    want = params_from_jax(jax.device_get(state_after.params), cfg)
    for name, p in model.named_parameters():
        grad_close(p.detach().numpy(), want[name].numpy(), name)


# ----------------------------------------- the runner, with recorded graphs

def test_runner_replays_match_eager_calls(monkeypatch):
    """Calls of K = 2, 2, 1, 2, 1 at accumulate 3 (phases 0, 2, 1, 2, 1)
    and a learning-rate cut: the recorded runner bit-equal to the eager
    calls, one graph per (K, phase), kept graphs reused, every replay
    counted."""
    base = port_model(dropout=0.1, n_convs=2)
    pool = [port_batch(b) for b in jax_batches(7, seed=300)]
    calls = [(pool[0:2], 2e-3), (pool[2:4], 2e-3), (pool[4:5], 1e-3),
             (pool[5:7], 1e-3), (pool[0:1], 1e-3)]
    eager = clone_setup(base, accumulate=3)
    want = [multi_train_step(*eager[:2], tbatch.stack_batches(bs), eager[2],
                             lr) for bs, lr in calls]
    recorded_graphs(monkeypatch)
    RecordedGraph.made = 0
    trace.reset()
    runner = clone_setup(base, accumulate=3)
    for i, ((bs, lr), w) in enumerate(zip(calls, want)):
        got = multi_train_step(*runner[:2], tbatch.stack_batches(bs),
                               runner[2], lr)
        for key in w:
            assert np.array_equal(got[key], w[key]), (i, key)
        assert trace.counters()["train.replays"] == i + 1
    assert_same_state(eager, runner)
    kept = runner[1].train_graphs.graphs
    assert sorted((g.k, g.phase) for g in kept.values()) == \
        [(1, 1), (2, 0), (2, 2)]
    # the last two calls replayed kept graphs
    assert RecordedGraph.made == 3 == trace.counters()["train.captures"]
    # a weight in new storage frees the kept graphs
    param = next(runner[0].parameters())
    old = param.data
    param.data = old.clone()
    multi_train_step(*runner[:2], tbatch.stack_batches(pool[0:1]),
                     runner[2], 1e-3)
    assert len(kept) == 1 and RecordedGraph.made == 4


def test_stale_batches_fault_misses(monkeypatch):
    """The runner with its input copy dropped (a planted fault) replays
    the first call's batches: its losses leave the eager ones'."""
    base = port_model(n_convs=2)
    pool = [port_batch(b) for b in jax_batches(4, seed=400)]
    eager = clone_setup(base)
    want = [multi_train_step(*eager[:2], tbatch.stack_batches(pool[i:i + 2]),
                             eager[2], 2e-3)["train total loss"]
            for i in (0, 2)]
    recorded_graphs(monkeypatch)
    runner = clone_setup(base)
    multi_train_step(*runner[:2], tbatch.stack_batches(pool[0:2]),
                     runner[2], 2e-3)
    graphs, = runner[1].train_graphs.graphs.values()
    monkeypatch.setattr(graphs, "load", lambda *a: None)
    stale = multi_train_step(*runner[:2], tbatch.stack_batches(pool[2:4]),
                             runner[2], 2e-3)["train total loss"]
    assert np.abs(stale - want[1]).max() > 10 * 1e-5 * np.abs(want[1]).max()


# ---------------------------------------------------- the trainer's calls

def schedule_config(data_dir):
    return {
        "training": {"batch_size": 2, "validation_splits": [2],
                     "steps_per_call": K,
                     "trainer_args": {"max_epochs": 2,
                                      "limit_val_batches": 2},
                     "evaluation": {"pharms_per_pocket": 1, "n_pockets": 1,
                                    "sample_interval": 0.6,
                                    "val_loss_interval": 0.3}},
        "lr_scheduler": {"base_lr": 3e-3, "weight_decay": 1e-12,
                         "reducelronplateau": {"patience": 0,
                                               "factor": 0.7}},
        "checkpointing": {"save_last": True, "save_top_k": 1},
        "wandb": {"mode": "disabled"},
        "dataset": {"raw_data_dir": "", "processed_data_dir": str(data_dir),
                    "prot_elements": ELEMENTS, "ph_type_map": PH_TYPES,
                    "subsample_pharms": True, "subsample_min": 3,
                    "subsample_max": 8},
        "graph": {"graph_cutoffs": CUTOFFS, "pp_k_max": 8},
        "diffusion": {"n_timesteps": 10, "precision": 1e-4},
        "dynamics": {"vector_size": 4, "n_convs": 2, "n_hidden_scalars": 16,
                     "message_norm": "mean", "dropout": 0.1, "pf_k": 3,
                     "n_message_gvps": 2, "n_update_gvps": 1,
                     "n_noise_gvps": 2},
    }


def jax_chunk_rule(shapes, k):
    """The JAX trainer's calls over one epoch's padded batch shapes
    (trainer.py:371-389): batch indices per call."""
    calls, pending = [], {}
    for i, shape in enumerate(shapes):
        entries = pending.setdefault(shape, [])
        entries.append(i)
        if len(entries) == k:
            calls.append(pending.pop(shape))
    for entries in pending.values():
        calls.extend([i] for i in entries)
    return calls


def jax_cadence(calls_per_epoch, n_batches, sample_interval, val_interval):
    """The global steps at which the JAX trainer's after_step
    (trainer.py:307-344) samples and validates, over the given calls."""
    step, last_sample, last_val = 0, 0.0, 0.0
    samples, vals = [], []
    for epoch, (calls, n) in enumerate(zip(calls_per_epoch, n_batches)):
        for call in calls:
            for batch_idx in call:
                step += 1
                exact = epoch + batch_idx / n
                if exact - last_sample >= sample_interval:
                    last_sample = exact
                    samples.append(step)
                if exact - last_val >= val_interval:
                    last_val = exact
                    vals.append(step)
    return samples, vals


def test_trainer_calls_follow_the_chunk_rule(tmp_path, monkeypatch):
    data = make_synthetic_processed_dataset(
        str(tmp_path / "data"), n_splits=3, samples_per_split=11,
        n_prot_range=(24, 90), seed=4, site_rule="deterministic")
    config = schedule_config(data)
    dm = data_module_from_config(config)
    dm.setup("fit")
    epochs = []
    for epoch in range(2):
        epochs.append([pad_batch_to_multiple(b, 2)[0]
                       for b in dm.train_dataloader(seed=epoch)])
    shapes = [[b.prot_x.shape for b in bs] for bs in epochs]
    assert len({s for ss in shapes for s in ss}) == 2     # two buckets
    want_calls = [jax_chunk_rule(ss, K) for ss in shapes]
    assert any(len(c) == K for c in want_calls[0])
    assert any(len(c) == 1 for c in want_calls[0])

    log = []           # ("call", batches, lr) / ("val" | "sample", step)
    trained = [0]
    real_call = Trainer.train_call

    def train_call(self, batches):
        log.append(("call", [b.prot_x.copy() for b in batches], self.lr))
        out = real_call(self, batches)
        trained[0] += len(batches)
        return out

    real_validate, real_sample = Trainer.validate, Trainer.sample_and_analyze

    def validate(self, datamodule):
        log.append(("val", self.global_step, trained[0]))
        out = real_validate(self, datamodule)
        # a flat validation loss: with patience 0 every validation after
        # the first cuts the rate
        return dict(out, **{"val total loss": 1.0})

    def sample(self, val_dataset):
        log.append(("sample", self.global_step, trained[0]))
        return real_sample(self, val_dataset)

    monkeypatch.setattr(Trainer, "train_call", train_call)
    monkeypatch.setattr(Trainer, "validate", validate)
    monkeypatch.setattr(Trainer, "sample_and_analyze", sample)
    trainer = Trainer(config, tmp_path / "run", device="cpu")
    trainer.fit(model_from_config(config, device="cpu"), dm)

    # the calls: grouped per padded shape, leftovers single at the end
    calls = [e for e in log if e[0] == "call"]
    flat_want = [[epochs[ep][i] for i in call]
                 for ep, wc in enumerate(want_calls) for call in wc]
    assert [len(c[1]) for c in calls] == [len(c) for c in flat_want]
    for (_, got, _), want in zip(calls, flat_want):
        assert all(np.array_equal(g, w.prot_x) for g, w in zip(got, want))
    # validation and sampling on the state after a call, at JAX's steps
    boundaries = set(np.cumsum([len(c) for c in flat_want]).tolist())
    n_steps = int(sum(len(c) for c in flat_want))
    samples, vals = jax_cadence(want_calls, [len(bs) for bs in epochs],
                                0.6, 0.3)
    assert len(vals) >= 2
    assert all(e[2] in boundaries for e in log if e[0] in ("val", "sample"))
    assert [e[1] for e in log if e[0] == "sample"] == samples
    # mid-epoch validations at JAX's steps, plus one at each epoch's end
    epoch_ends = np.cumsum([len(bs) for bs in epochs]).tolist()
    want_val = sorted(vals + epoch_ends)
    assert [e[1] for e in log if e[0] == "val"] == want_val
    # one rate a call; a cut takes effect at the next call
    lrs = [c[2] for c in calls]
    assert lrs[0] == 3e-3 and min(lrs) < 3e-3
    records = [json.loads(ln) for ln in
               (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in records if "train total loss" in r]
    assert len(rows) == n_steps == trainer.global_step
    assert [r["step"] for r in rows] == list(range(1, n_steps + 1))
    first = 0
    for i, (_, batches, lr) in enumerate(calls):
        # the rate the call ran at: the one logged by its first row
        assert rows[first]["lr"] == lr
        first += len(batches)
    cuts = [i for i in range(1, len(lrs)) if lrs[i] < lrs[i - 1]]
    assert cuts
    losses = [r["train total loss"] for r in rows]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    # one optimizer step counted per batch
    assert trainer.global_step == n_steps
