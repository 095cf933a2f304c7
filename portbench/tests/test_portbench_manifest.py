"""BENCHMARK.json against the benchmark's contract, and the harness
finding every cell's files by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest()


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(one_line(w) for w in bench["command"])
    assert bench["command"][1].startswith(bench["paths"][0] + "/")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_entries(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(bench["paths"][0] + "/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in bench["workloads"]} == \
        {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_the_issue_names(bench):
    assert [c["name"] for c in bench["configs"]] == ["pforge-full",
                                                     "pforge-dev"]
    assert [w["name"] for w in bench["workloads"]] == [
        "full-screen", "full-train", "dev-train"]
    assert {m["name"] for m in bench["end_to_end"]} == {
        "samples_per_s", "train_steps_per_s", "setup_s"}


def test_end_to_end_bounds(bench):
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    assert setup[0]["bound"] == 0.25


def reported(bench, cell: str, key: str):
    return {m["name"] for m in bench[key]
            if cell in m.get("workloads", [cell])}


def test_every_cell_reports_enough(bench):
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        e2e = reported(bench, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reported(bench, w["name"], "per_layer")


def test_layer_metrics_move_what_their_cells_report(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in reported(bench, cell, "end_to_end")
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"chain runner", "denoiser", "kernels",
                           "train runner and step", "trainer and loader",
                           "device", "whole step"}


def test_harness_finds_every_file_by_name(bench):
    for w in bench["workloads"]:
        cell = manifest.Cell.find(bench, w["name"])
        assert (manifest.ROOT / "workloads"
                / f"{cell.traffic['kind']}.py").is_file()
        assert cell.limits and all("limit" in v
                                   for v in cell.limits.values())
        assert cell.config["name"] == w["config"]
        for m in cell.per_layer:
            assert callable(manifest.metric_reader(m["name"]))
    with pytest.raises(KeyError):
        manifest.Cell.find(bench, "no-such-cell")


def test_configs_keep_their_widths(bench):
    for c in bench["configs"]:
        cfg = manifest.read_json(manifest.REPO / c["file"])
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
        m = cfg["model"]
        assert (m["n_hidden_scalars"], m["vector_size"], m["n_message_gvps"],
                m["n_update_gvps"], m["n_noise_gvps"], m["pf_k"],
                m["pp_k_max"]) == (128, 16, 3, 2, 4, 5, 16)
        assert m["graph_cutoffs"]["pp"] == 3.5


def test_every_mix_names_a_workload_kind():
    for path in (manifest.ROOT / "traffic").glob("*.json"):
        kind = manifest.read_json(path)["kind"]
        assert (manifest.ROOT / "workloads" / f"{kind}.py").is_file(), path


def test_every_end_to_end_metric_has_a_statistic(bench):
    """The harness reads each end-to-end metric's statistic from its name
    and unit: a rate, a latency percentile, the set-up time."""
    import argparse

    from portbench import harness
    cell = manifest.Cell.find(bench, bench["workloads"][0]["name"])
    cell.end_to_end = bench["end_to_end"] + [
        {"name": "request_p95_ms", "unit": "ms"}]
    run = harness.Run(argparse.Namespace(seed=1), cell, "cpu", 0.0)
    run.calls = [(i, float(i), i + 0.5 + 0.01 * i, 2) for i in range(100)]
    got = harness.end_to_end(run, 100.0, 3.0)
    assert set(got) == {m["name"] for m in cell.end_to_end}
    assert got["setup_s"] == {"value": 3.0, "unit": "s"}
    assert got["samples_per_s"]["value"] == 2.0
    assert got["request_p95_ms"]["value"] == pytest.approx(
        500 + 10 * 94.05)
