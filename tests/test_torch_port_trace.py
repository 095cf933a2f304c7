"""The port's spans and counters (`pharmaforge_tpu_torch/utils/trace.py`),
on the CPU, at a tiny size.

* Under `torch.profiler` a `sample_stacked`, a `sample_pocket`, a
  `train_call` fed through `prefetch` and a `validate` each open one root
  "pf." span with their phases nested inside it, eager and (with the
  stand-in for CUDA graphs of `tests/recorded_graphs.py`) through the
  graph runners;
* the same calls without a profiler enter no record function and leave
  no span in the ring;
* the ring holds one "loader.pack" per batch a prefetcher hands over,
  stamped on the producer thread, with whether it was already queued;
* the registry counts what the counting points count: correction passes,
  launches (none on the CPU), captures and replays;
* the registry under concurrent counting, and spans closed by an
  exception inside them.
"""

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (one torch thread a worker)
from pharmaforge_tpu_torch.config.load_from_config import (
    data_module_from_config,
    model_from_config,
)
from pharmaforge_tpu_torch.data import synthetic
from pharmaforge_tpu_torch.data.batch import pad_batch_to_multiple
from pharmaforge_tpu_torch.data.prefetch import prefetch
from pharmaforge_tpu_torch.models import conv
from pharmaforge_tpu_torch.training.optim import Adam
from pharmaforge_tpu_torch.training.sampling import PocketSampler
from pharmaforge_tpu_torch.training.trainer import Trainer
from pharmaforge_tpu_torch.utils import trace
from tests.recorded_graphs import recorded_graphs
from tests.test_torch_port_train import tiny_config

T = 10                 # tiny_config's n_timesteps
SLOTS = 64             # the sampler's prot slots (pockets of 30-50 atoms)

SAMPLER = {"sampler.call", "sampler.tile", "sampler.probe", "chain.setup",
           "chain.run", "chain.fetch", "sampler.split"}
TRAINER = {"trainer.call", "trainer.stack", "train.fetch"}
# each call's root and the phases it must hold, eager and graphed (the
# first call of a signature captures)
EXPECTED = {
    ("sample_stacked", False): SAMPLER | {"chain.eager"},
    ("sample_stacked", True): SAMPLER | {"chain.graphs", "chain.capture",
                                         "chain.replay"},
    ("sample_pocket", False): SAMPLER | {"chain.eager"},
    ("train_call", False): TRAINER | {"train.eager"},
    ("train_call", True): TRAINER | {"train.graphs", "train.capture",
                                     "train.load", "train.replay"},
    ("validate", False): {"trainer.validate"},
    ("validate", True): {"trainer.validate", "eval.capture"},
}
ROOTS = {"sample_stacked": "sampler.call", "sample_pocket": "sampler.call",
         "train_call": "trainer.call", "validate": "trainer.validate"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny config over a synthetic dataset: its model, data module and
    a trainer ready for `train_call` and `validate`."""
    root = tmp_path_factory.mktemp("trace")
    data = synthetic.make_synthetic_processed_dataset(
        str(root / "data"), n_splits=3, samples_per_split=6,
        n_prot_range=(30, 50), seed=1, site_rule="deterministic")
    config = tiny_config(data, max_epochs=1)
    torch.manual_seed(0)
    model = model_from_config(config, device="cpu")
    dm = data_module_from_config(config)
    dm.setup("fit")
    return config, model, dm, root


def make_trainer(setup):
    config, model, dm, root = setup
    trainer = Trainer(config, root / "run", device="cpu")
    trainer.model = model
    trainer.optimizer = Adam(model.parameters(), 1e-3, 0.0)
    trainer.generator = torch.Generator().manual_seed(3)
    return trainer


def slowly(items, pause_s=0.02):
    """`items`, each after a pause: a prefetcher's consumer waits."""
    for item in items:
        time.sleep(pause_s)
        yield item


def run_call(kind: str, setup, graphed: bool, monkeypatch):
    """One public call of `kind` on `setup`; with `graphed`, through the
    graph runners with the stand-in for CUDA graphs."""
    config, model, dm, _ = setup
    if kind in ("sample_stacked", "sample_pocket"):
        if graphed:
            recorded_graphs(monkeypatch)
            model._chain_graphs.clear()
        pockets = [dm.val_dataset[i] for i in range(2)]
        sampler = PocketSampler(model, fixed_prot_slots=SLOTS, device="cpu")
        gen = torch.Generator().manual_seed(5)
        if kind == "sample_stacked":
            return sampler.sample_stacked(pockets, [[4, 5, 6]] * 2, gen)
        return sampler.sample_pocket(pockets[0], [4, 5, 6], gen)
    if graphed:
        recorded_graphs(monkeypatch)
    trainer = make_trainer(setup)
    if kind == "validate":
        return trainer.validate(dm)
    k = config["training"]["steps_per_call"]
    feed = prefetch(slowly(dm.train_dataloader(seed=0)))
    batches = [pad_batch_to_multiple(next(feed), trainer.batch_size)[0]
               for _ in range(k)]
    feed.close()
    return trainer.train_call(batches)


def profiled_spans(prof):
    """(name without "pf.", start ns, end ns, thread) of every pf. span
    the profiler recorded on the host."""
    from torch.autograd import DeviceType
    return [(e.name()[3:], e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("pf.")
            and e.device_type() == DeviceType.CPU]


@pytest.mark.parametrize("kind,graphed", list(EXPECTED))
def test_profiled_call_opens_one_root_and_nests_its_phases(
        setup, monkeypatch, kind, graphed):
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_call(kind, setup, graphed, monkeypatch)
    spans = profiled_spans(prof)
    names = {n for n, *_ in spans}
    # the loader's waits are roots of their own, outside the call
    waits = [s for s in spans if s[0] == "loader.wait"]
    if kind == "train_call":
        assert waits, "the first batch of a slow loader was waited for"
    spans = [s for s in spans if s[0] != "loader.wait"]
    assert names - {"loader.wait"} >= EXPECTED[kind, graphed], names
    roots = [s for s in spans if s[0] == ROOTS[kind]]
    assert len(roots) == 1, roots
    _, r0, r1, thread = roots[0]
    for name, a, b, t in spans:
        assert t == thread and r0 <= a <= b <= r1, name
    if kind == "train_call":
        for _, a, b, _ in waits:
            assert b <= r0 or a >= r1
    # the ring holds the same spans, its phases inside its root
    recs = [r for r in trace.records() if r.name in names - {"loader.wait"}]
    assert sorted(r.name for r in recs) == sorted(s[0] for s in spans)
    root = [r for r in recs if r.name == ROOTS[kind]]
    assert len(root) == 1
    assert all(root[0].start_ns <= r.start_ns <= r.end_ns <= root[0].end_ns
               for r in recs)
    if graphed and kind == "sample_stacked":
        # no span sits inside a capture: the capture is a leaf
        cap = next(r for r in recs if r.name == "chain.capture")
        assert not any(cap.start_ns < r.start_ns and r.end_ns < cap.end_ns
                       for r in recs)


@pytest.mark.parametrize("kind,graphed", list(EXPECTED))
def test_unprofiled_call_enters_no_record_function(setup, monkeypatch,
                                                   kind, graphed):
    entered = []

    def annotation(name, *args, **kw):
        entered.append(name)
        raise AssertionError(f"record function {name!r} entered")

    monkeypatch.setattr(torch.profiler, "record_function", annotation)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        annotation)
    trace.reset()
    run_call(kind, setup, graphed, monkeypatch)
    assert not entered
    assert {r.name for r in trace.records()} <= {"loader.pack"}


@pytest.mark.parametrize("producer_pause,consumer_pause,queued",
                         [(0.05, 0.0, False), (0.0, 0.05, True)])
def test_ring_holds_one_pack_per_batch(producer_pause, consumer_pause,
                                       queued):
    """A slow producer leaves the consumer waiting for every batch; a slow
    consumer finds every batch after the first already queued."""
    trace.reset()
    threads, made = set(), []

    def items():
        for i in range(6):
            time.sleep(producer_pause)
            threads.add(threading.get_ident())
            made.append(time.perf_counter_ns())
            yield i

    got = []
    for item in prefetch(items()):
        time.sleep(consumer_pause)
        got.append(item)
    assert got == list(range(6))
    recs = trace.records("loader.pack")
    assert [r.seq for r in recs] == list(range(6))
    # each record times the producer thread's `next`, which made the item
    assert len(threads) == 1 and threading.get_ident() not in threads
    for r, t in zip(recs, made):
        assert r.start_ns <= t <= r.end_ns <= r.taken_ns
        if producer_pause:
            assert r.end_ns - r.start_ns >= producer_pause * 1e9 * 0.5
    if queued:
        assert [r.queued for r in recs[1:]] == [True] * 5
    else:
        assert [r.queued for r in recs] == [False] * 6


def count_corrections(monkeypatch):
    """Calls of the correction pass, counted beside the registry."""
    calls = []
    real = conv.GVPMultiEdgeConv._fused_pp_corrected

    def counted(self, *args, **kw):
        calls.append(1)
        return real(self, *args, **kw)

    monkeypatch.setattr(conv.GVPMultiEdgeConv, "_fused_pp_corrected", counted)
    return calls


@pytest.mark.parametrize("kind,graphed", [("sample_stacked", False),
                                          ("sample_stacked", True),
                                          ("train_call", True),
                                          ("validate", True)])
def test_registry_counts_what_the_counting_points_count(
        setup, monkeypatch, kind, graphed):
    calls = count_corrections(monkeypatch)
    trace.reset()
    run_call(kind, setup, graphed, monkeypatch)
    counts = trace.counters()
    # no kernel launches on the CPU: the wrappers run their plain versions
    for name in ("knn_select.launches", "pp_message.launches",
                 "pp_message.bwd_launches"):
        assert counts[name] == 0
    assert counts["conv.corrections"] == len(calls)
    if kind == "sample_stacked":
        if not graphed:
            # one correction pass a denoiser step
            assert len(calls) == T
            assert counts["chain.captures"] == counts["chain.replays"] == 0
        else:
            # a warm-up step, one captured step (U = 1), and the stand-in's
            # replays rerun the step's host code, which a CUDA graph's
            # replay does not
            assert len(calls) == 2 + T
            assert counts["chain.captures"] == 1
            assert counts["chain.replays"] == T
            assert counts["chain.replayed.corrections"] == T
    elif kind == "train_call":
        assert (counts["train.captures"], counts["train.replays"]) == (1, 1)
        assert len(calls) == 0          # train mode runs the full width
    else:
        n_val = len(setup[2].val_dataloader(seed=0))
        assert counts["eval.replays"] == n_val >= 1
        assert counts["eval.captures"] >= 1


def test_counters_under_concurrent_counting():
    trace.reset()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [trace.count("stress") for _ in range(2000)])
            for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert trace.counters()["stress"] == 8 * 2000
    trace.count("stress", -16000)
    assert trace.counters()["stress"] == 0


def test_spans_close_after_an_exception():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError("inside")
        with trace.span("after"):
            pass
    for got in ([(r.name, r.start_ns, r.end_ns) for r in trace.records()],
                [s[:3] for s in profiled_spans(prof)]):
        at = {name: (a, b) for name, a, b in got}
        assert sorted(at) == ["after", "inner", "outer"]
        assert at["outer"][0] <= at["inner"][0] <= at["inner"][1] \
            <= at["outer"][1] <= at["after"][0] <= at["after"][1]
    # without the profiler a span is the one shared null context
    assert trace.span("x") is trace.span("y")
