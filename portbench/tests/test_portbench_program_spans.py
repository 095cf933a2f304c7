"""The readers of the program's spans (`program_spans.py` and the metrics
that use it) on synthetic traces: a traced call's device operations, the
benchmark's annotations and the program's `pf.` annotations as the
profiler gives them, and the program's ring as the program fills it.

* the accepted readers and `Trace.spans("call")` read the same with and
  without the program's annotations in the trace;
* a device gap inside `pf.train.load` is named `pf.train.load`;
* `sampler_idle_ms.screen + chain_gap_ms.screen + remainder` is
  `chain_host_ms.screen`;
* `train_call_idle_ms` leaves the replay's and fetch's idle out;
* `loader_pack_ms` reads only the batches the traced calls took;
* against a program without the ring, every new reader returns None.
"""

from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from pharmaforge_tpu_torch.utils.trace import Record
from portbench import manifest, program_spans, trace

OFFSET = 5000.0        # the profiler's clock minus perf_counter, in s
ACCEPTED = ["chain_host_ms.screen", "denoiser_step_ms.screen",
            "k1_roofline.screen", "k2_roofline.screen", "k2_roofline.train",
            "k3_roofline.train", "train_step_device_ms", "loader_wait_ms",
            "device_idle.screen", "device_idle.train", "mfu.screen",
            "mfu.train"]
NEW = ["sampler_idle_ms.screen", "chain_gap_ms.screen",
       "train_call_idle_ms", "loader_pack_ms"]


class Event:
    """A profiler event: its name, device, start and end in ns."""

    def __init__(self, name, a, b, device=False):
        self._name, self.a, self.b = name, int(a * 1e9), int(b * 1e9)
        self.device = device

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self.device else DeviceType.CPU

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def duration_ns(self):
        return self.b - self.a


def profiler_of(events):
    results = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def span_record(name, a, b):
    return Record(name, int(a * 1e9), int(b * 1e9))


# a traced screening call on perf_counter s: the program's spans (name,
# start, end) and the device operations (name, start, end)
SCREEN_SPANS = [("sampler.call", 100.010, 100.990),
                ("sampler.tile", 100.010, 100.020),
                ("sampler.probe", 100.020, 100.030),
                ("chain.setup", 100.030, 100.050),
                ("chain.graphs", 100.050, 100.060),
                ("chain.run", 100.060, 100.970),
                ("chain.replay", 100.060, 100.070),
                ("chain.fetch", 100.070, 100.970),
                ("sampler.split", 100.970, 100.985)]
SCREEN_OPS = ([("probe_kernel", 100.022, 100.025),
               ("setup_kernel", 100.032, 100.045)]
              + [("knn_select_kernel", 100.062 + 0.01 * i,
                  100.0695 + 0.01 * i) for i in range(80)]
              + [("pp_message_kernel", 100.9, 100.95),
                 ("copy", 100.955, 100.96)])
# a traced train call: loader wait, then the call's phases
TRAIN_SPANS = [("trainer.call", 200.100, 200.900),
               ("trainer.stack", 200.100, 200.150),
               ("train.graphs", 200.150, 200.160),
               ("train.load", 200.160, 200.300),
               ("train.replay", 200.300, 200.310),
               ("train.fetch", 200.310, 200.900)]
TRAIN_OPS = [("copy", 200.165, 200.170),
             ("copy", 200.280, 200.300),
             ("knn_select_kernel", 200.305, 200.400),
             ("pp_message_bwd_kernel", 200.400, 200.850),
             ("copy", 200.850, 200.860)]


def fake_run(kind, with_pf=True, ring=True):
    """A traced run of one call: its spans on both clocks, its trace and,
    with `ring`, the program's ring (None: a program without one)."""
    if kind == "screen":
        h0, h1, spans, ops = 100.0, 101.0, SCREEN_SPANS, SCREEN_OPS
        bench = [("call", h0, h1)]
    else:
        h0, h1, spans, ops = 200.0, 201.0, TRAIN_SPANS, TRAIN_OPS
        bench = [("call", h0, h1), ("loader_wait", 200.0, 200.09),
                 ("train_call", 200.095, 200.95)]
    events = [Event(f"bench.{n}", a + OFFSET, b + OFFSET)
              for n, a, b in bench]
    events += [Event(n, a + OFFSET, b + OFFSET, device=True)
               for n, a, b in ops]
    if with_pf:
        events += [Event(f"pf.{n}", a + OFFSET, b + OFFSET)
                   for n, a, b in spans]
    run = types.SimpleNamespace(
        trace=trace.Trace(profiler_of(events)),
        traced=[(0, h0 + 1e-4, h1 - 1e-4)],
        calls=[(0, h0 + 1e-4, h1 - 1e-4, 8)],
        spans=trace.Spans(),
        work={"k1": 1e-5, "k2": 2e-3, "k3": 1e-3, "peak_s_per_step": 1e-4})
    run.spans.items = [(n, a, b, {}) for n, a, b in bench]
    records = [span_record(n, a, b) for n, a, b in spans]
    return run, (records if ring else None)


def reading(run, records, name, monkeypatch):
    monkeypatch.setattr(program_spans, "ring", lambda: records)
    return manifest.metric_reader(name)(run)


@pytest.mark.parametrize("kind", ["screen", "train"])
def test_accepted_readers_read_the_same_with_program_annotations(
        kind, monkeypatch):
    bare, records = fake_run(kind, with_pf=False)
    full, _ = fake_run(kind, with_pf=True)
    assert full.trace.spans("call") == bare.trace.spans("call")
    assert full.trace.annotations == bare.trace.annotations
    for name in ACCEPTED:
        assert reading(full, records, name, monkeypatch) == \
            reading(bare, records, name, monkeypatch), name


def test_a_gap_inside_train_load_is_named_after_it(monkeypatch):
    run, records = fake_run("train")
    monkeypatch.setattr(program_spans, "ring", lambda: records)
    by_length = {round(t, 6): n for n, t in program_spans.named_gaps(run)}
    # 200.170-200.280 s inside pf.train.load, 200.300-200.305 s inside
    # pf.train.replay
    assert by_length[0.11] == "pf.train.load"
    assert by_length[0.005] == "pf.train.replay"
    # the accepted breakdown names both after the benchmark's span
    accepted = {round(t, 6): n for n, t in
                run.trace.idle_gaps(*run.trace.spans("call")[0])}
    assert accepted[0.11] == accepted[0.005] == "train_call"


def test_the_screening_split_adds_up_to_chain_host_ms(monkeypatch):
    run, records = fake_run("screen")
    got = {n: reading(run, records, n, monkeypatch)
           for n in ("chain_host_ms.screen", "sampler_idle_ms.screen",
                     "chain_gap_ms.screen")}
    rest, outside, inside = program_spans.remainder_ms(run)
    assert got["sampler_idle_ms.screen"] + got["chain_gap_ms.screen"] \
        + rest == pytest.approx(got["chain_host_ms.screen"], rel=1e-9)
    # by hand: the phases' 65 ms less the probe's 3 and set-up's 13 ms of
    # device work; chain.run's 910 ms less its 80 x 7.5 + 50 + 5 ms; the
    # call's first 10 and last 15 ms, 20 of them outside sampler.call
    assert got["sampler_idle_ms.screen"] == pytest.approx(49.0, abs=1e-6)
    assert got["chain_gap_ms.screen"] == pytest.approx(255.0, abs=1e-6)
    assert outside == pytest.approx(20.0, abs=1e-6)
    assert inside == pytest.approx(5.0, abs=1e-6)


def test_train_call_idle_leaves_out_replay_and_fetch(monkeypatch):
    run, records = fake_run("train")
    got = reading(run, records, "train_call_idle_ms", monkeypatch)
    # the call's first 200 ms (stack, graphs, load) less their 25 ms of
    # copies; the replay's 5 and the fetch's 40 ms of idle are out
    assert got == pytest.approx(175.0, abs=1e-6)
    whole = program_spans.mean_idle_ms(run, ("trainer.call",))
    assert whole == pytest.approx(175.0 + 5.0 + 40.0, abs=1e-6)


def test_loader_pack_reads_only_the_traced_calls_batches(monkeypatch):
    run, records = fake_run("train")
    # a second, untraced call of the window
    run.calls.append((1, 201.0, 202.0, 8))
    packs = []
    for seq, (start, took, taken) in enumerate([
            (199.5, 0.004, 200.05), (199.6, 0.006, 200.08),
            (200.5, 0.020, 201.05), (200.6, 0.030, 201.08)]):
        r = Record("loader.pack", int(start * 1e9),
                   int((start + took) * 1e9), seq=seq)
        r.taken_ns, r.queued = int(taken * 1e9), seq % 2 == 0
        packs.append(r)
    got = reading(run, records + packs, "loader_pack_ms", monkeypatch)
    assert got == pytest.approx(5.0, abs=1e-6)
    window = program_spans.loader_batches(run, traced_only=False)
    assert [r.seq for r in window] == [0, 1, 2, 3]


@pytest.mark.parametrize("name", NEW)
def test_new_readers_find_nothing_without_the_ring(name, monkeypatch):
    kind = "screen" if name.endswith(".screen") else "train"
    run, records = fake_run(kind, ring=False)
    assert reading(run, records, name, monkeypatch) is None
