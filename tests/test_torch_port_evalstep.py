"""PyTorch/CUDA port, the validation step (`training/train_state.py::
eval_step`, the counterpart of JAX `make_eval_step`) and the trainer's
validation, on the CPU.

* The eval-mode loss metrics against `make_eval_step`'s with JAX's own
  draws injected, endpoint parameterization on and off: every `val *`
  metric within rtol 1e-5 (nothing else holds the eval-mode metrics to
  JAX; test_torch_port_train.py holds `train=True`);
* the runner (`EvalGraphs`: warm-up, capture, input copies, kept graphs,
  freed when a weight moves) with the stand-in for CUDA graphs of
  test_torch_port_multistep.py, validations of two batch shapes between
  recorded train calls: bit-equal to eager `eval_step`, one graph per
  signature, every replay counted;
* `Trainer.validate`'s one-copy collection bit-equal to the per-batch
  path (the JAX trainer's, trainer.py:425-455) with `limit_val_batches`
  as a fraction and as a count;
* a planted fault, a validation graph over a copy of the weights
  (`chip_smoke.frozen_weights`), differs from eager after one train call.
JAX matmuls run in full fp32 (tests/conftest.py).
"""

import numpy as np
import jax
import pytest
import torch

import chip_smoke
from pharmaforge_tpu.models.diffusion import (
    DiffusionConfig as JaxConfig,
    PharmacophoreDiffusion as JaxDiffusion,
)
from pharmaforge_tpu.training.train_state import make_eval_step
from pharmaforge_tpu_torch.config.load_from_config import (
    data_module_from_config,
    model_from_config,
)
from pharmaforge_tpu_torch.data import batch as tbatch
from pharmaforge_tpu_torch.data.batch import pad_batch_to_multiple
from pharmaforge_tpu_torch.data.prefetch import prefetch
from pharmaforge_tpu_torch.data.synthetic import (
    make_synthetic_processed_dataset,
)
from pharmaforge_tpu_torch.interop import params_from_jax
from pharmaforge_tpu_torch.models import diffusion
from pharmaforge_tpu_torch.models.diffusion import (
    DiffusionConfig,
    PharmacophoreDiffusion,
)
from pharmaforge_tpu_torch.training import train_state
from pharmaforge_tpu_torch.training.train_state import (
    eval_step,
    multi_train_step,
)
from pharmaforge_tpu_torch.training.trainer import Trainer
from tests.conftest import make_complex_batch
from tests.test_torch_port_multistep import (
    RecordedGraph,
    assert_same_state,
    clone_setup,
    jax_batches,
    one_thread,  # noqa: F401  (a fixture)
    port_model,
    recorded_capture,
    schedule_config,
    small_kw,
)
from tests.test_torch_port_train import port_batch


# ---------------------------------------------------------- against JAX

@pytest.mark.parametrize("endpoint", [False, True])
def test_eval_metrics_match_jax(rng, endpoint):
    kw = small_kw(endpoint_param_feat=endpoint,
                  endpoint_param_coord=endpoint)
    jb = make_complex_batch(rng, b=3, p=40, f_valid=(5, 3, 7),
                            p_valid=(36, 30, 40))
    jb = jb.replace(prot_x=jb.prot_x * 0.4)      # pp edges at 3.5 A
    jmodel = JaxDiffusion(JaxConfig(fused_pp=False, **kw))
    params = jmodel.init_params(jax.random.key(1), jb)
    key = jax.random.key(7)
    j_aux = make_eval_step(jmodel)(params, jb, key)
    # the JAX loss's own draws, injected into the port
    k_t, k_ex, k_eh, _ = jax.random.split(key, 4)
    b, f = jb.pharm_mask.shape
    noise = {"t_int": np.asarray(jax.random.randint(k_t, (b,), 0, 20)),
             "eps_x": np.asarray(jax.random.normal(k_ex, (b, f, 3))),
             "eps_h": np.asarray(jax.random.normal(k_eh, (b, f, 6)))}

    cfg = DiffusionConfig(**kw)
    model = PharmacophoreDiffusion(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), cfg))
    with torch.no_grad():
        _, aux = model.loss(port_batch(jb), train=False, phase="val",
                            noise=noise)
    assert not model.training
    assert set(aux) == set(j_aux) and all(k.startswith("val ") for k in aux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(j_aux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# ----------------------------------------- the runner, with recorded graphs

def recorded_eval(monkeypatch):
    """`recorded_capture`, and validation captures recorded too: a
    capture runs the forward's host code and undoes its draws (a capture
    enqueues nothing); a replay reruns it."""
    recorded_capture(monkeypatch)
    real_body = train_state.EvalGraphs._body

    def body(self):
        RecordedGraph.capturing[-1].body = lambda: real_body(self)
        rng = self.generator.get_state()
        real_body(self)
        self.generator.set_state(rng)

    monkeypatch.setattr(train_state.EvalGraphs, "_body", body)


def val_batch(seed, p):
    """A port batch of 3 pockets in `p` prot slots (pp edges at 3.5 A)."""
    jb = make_complex_batch(np.random.default_rng(seed), b=3, p=p,
                            f_valid=(5, 3, 7), p_valid=(p - 4, p - 10, p))
    return port_batch(jb.replace(prot_x=jb.prot_x * 0.4))


def run_ops(setup, ops):
    """Each op on `setup`: ("val", batch) an `eval_step`, ("train",
    batches) a `multi_train_step` call at 2e-3; their results."""
    model, opt, gen = setup
    return [eval_step(model, arg, gen) if op == "val" else
            multi_train_step(model, opt, tbatch.stack_batches(arg), gen,
                             2e-3) for op, arg in ops]


def test_runner_replays_match_eager_validation(one_thread, monkeypatch):
    """Validations of two batch shapes between train calls: the recorded
    runner bit-equal to eager `eval_step` (metrics, weights, generator),
    one graph per signature kept on the model and reused, every replay
    counted; a weight in new storage frees the kept graphs."""
    base = port_model(dropout=0.1, n_convs=2)
    train = [port_batch(b) for b in jax_batches(3, seed=500)]
    a = [val_batch(600 + i, 40) for i in range(2)]
    b = val_batch(700, 24)
    ops = [("val", a[0]), ("val", b), ("train", train[:2]), ("val", a[1]),
           ("val", b), ("train", train[2:]), ("val", a[0])]
    eager = clone_setup(base)
    want = run_ops(eager, ops + [("val", b)])
    recorded_eval(monkeypatch)
    RecordedGraph.made = 0
    diffusion.eval_graph_replays = 0
    runner = clone_setup(base)
    got = run_ops(runner, ops)
    for i, ((op, _), g, w) in enumerate(zip(ops, got, want)):
        assert set(g) == set(w), i
        for key in w:
            assert np.array_equal(g[key], w[key]), (i, op, key)
    n_val = sum(op == "val" for op, _ in ops)
    assert diffusion.eval_graph_replays == n_val
    kept = runner[0]._eval_graphs
    assert sorted(g.inputs["prot_x"].shape[1] for g in kept.values()) == \
        [24, 40]
    # two validation graphs and the train graphs of 2 and 1 steps
    assert RecordedGraph.made == 4
    assert not runner[0].training
    # a weight in new storage frees the kept validation graphs
    param = next(runner[0].parameters())
    param.data = param.data.clone()
    assert eval_step(runner[0], b, runner[2]) == want[-1]
    assert len(runner[0]._eval_graphs) == 1 and RecordedGraph.made == 5
    assert_same_state(eager, runner)


def test_frozen_weights_fault_misses(one_thread, monkeypatch):
    """A validation graph over a copy of the weights (a planted fault)
    agrees with eager until a train call moves the weights, then leaves
    the eager metrics by more than 10 x the tolerance."""
    base = port_model(dropout=0.1, n_convs=2)
    train = [port_batch(b) for b in jax_batches(1, seed=800)]
    val = val_batch(900, 40)
    ops = [("val", val), ("train", train), ("val", val)]
    eager = clone_setup(base)
    want = run_ops(eager, ops)
    recorded_eval(monkeypatch)
    runner = clone_setup(base)
    with chip_smoke.frozen_weights():
        got = run_ops(runner, ops)
    assert got[0] == want[0]
    miss = chip_smoke.metric_miss(want[2], got[2])
    assert miss > 10, miss


# ------------------------------------------------ the one-copy collection

def per_batch_validate(trainer, datamodule):
    """The JAX trainer's validation (trainer.py:425-455): each batch's
    metrics to the host as it ends, summed weighted by its real size."""
    loader = datamodule.val_dataloader(seed=trainer.seed)
    n_batches, limit = len(loader), trainer.limit_val_batches
    if isinstance(limit, float):
        n_batches = max(int(n_batches * limit), 1) if limit > 0 else 0
    else:
        n_batches = min(n_batches, int(limit))
    sums, weights = {}, 0.0
    for batch_idx, batch in enumerate(prefetch(loader)):
        if batch_idx >= n_batches:
            break
        batch, bs = pad_batch_to_multiple(batch, trainer.batch_size)
        for k, v in eval_step(trainer.model, batch,
                              trainer.generator).items():
            sums[k] = sums.get(k, 0.0) + v * bs
        weights += bs
    return {k: v / max(weights, 1) for k, v in sums.items()}, n_batches


@pytest.mark.parametrize("limit", [0.6, 3])
def test_validate_one_copy_matches_per_batch(one_thread, tmp_path, limit):
    data = make_synthetic_processed_dataset(
        str(tmp_path / "data"), n_splits=3, samples_per_split=11,
        n_prot_range=(24, 90), seed=4, site_rule="deterministic")
    config = schedule_config(data)
    config["training"]["trainer_args"]["limit_val_batches"] = limit
    dm = data_module_from_config(config)
    dm.setup("fit")
    trainer = Trainer(config, tmp_path / "run", device="cpu")
    trainer.model = model_from_config(config, device="cpu")
    # the val set's pharmacophore subsampling draws from a generator that
    # lives with the dataset: both runs start it from the same state
    data_rng = dm.val_dataset._rng.bit_generator.state
    states, results = [], []
    for run in (per_batch_validate, lambda t, d: (t.validate(d), None)):
        trainer.generator = torch.Generator().manual_seed(3)
        dm.val_dataset._rng.bit_generator.state = data_rng
        results.append(run(trainer, dm))
        states.append(trainer.generator.get_state())
    (want, n_batches), (got, _) = results
    assert n_batches >= 2
    assert got == want and set(got) and all(
        k.startswith("val ") for k in got)
    assert torch.equal(*states)
