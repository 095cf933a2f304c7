"""The traffic generator: the same seed gives the same traffic, pockets
are as the mixes ask, and the reference re-derives the loader's batches."""

from __future__ import annotations

import argparse

import numpy as np
import pytest
import torch

from portbench import harness, traffic
from portbench.reference import loader as rl
from portbench.tests import tiny

BIG_SEED = 2 ** 31 + 977


def plans(name: str, seed: int):
    cell = tiny.cell(name) if name != "pocket" else tiny.unlisted(
        "pforge-dev", "pocket-30", {}, [])
    run = harness.Run(argparse.Namespace(workload=name, seed=seed,
                                         seconds=1.0, trace=0),
                      cell, torch.device("cpu"), 0.0)
    wl = harness.workload_for(run)
    wl.make_pool()
    return [(wl.plan(i), [p["prot_x"] for p in wl.pool]) for i in range(3)]


def same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


@pytest.mark.parametrize("name", ["full-screen", "pocket"])
def test_same_seed_same_traffic(name):
    assert same(plans(name, BIG_SEED), plans(name, BIG_SEED))
    assert not same(plans(name, BIG_SEED), plans(name, BIG_SEED + 1))


def test_derive_takes_large_seeds_and_keys():
    a = traffic.derive(2 ** 40 + 3, 4, -1)
    assert 0 <= a < 2 ** 63 and a == traffic.derive(2 ** 40 + 3, 4, -1)
    assert a != traffic.derive(2 ** 40 + 3, 4, 1)


@pytest.mark.parametrize("sizes", [[230] * 5, list(range(150, 301, 30))])
def test_pockets_have_their_sizes_and_spacing(sizes):
    pockets = traffic.make_pockets(np.random.default_rng(3), sizes, 11)
    for p, n in zip(pockets, sizes):
        x = p["prot_x"].astype(np.float64)
        assert len(x) == n and len(p["prot_elem"]) == n
        d2 = ((x[:, None] - x[None]) ** 2).sum(-1) + np.eye(n) * 1e9
        assert np.sqrt(d2.min()) > traffic.MIN_SPACING - 1e-3
        r = np.linalg.norm(x, axis=1)
        assert r.min() > 1.0 and r.max() < 15.0


def test_spaced_sizes_are_the_same_set_for_every_seed():
    s = traffic.spaced_sizes(150, 300, 48)
    assert s[0] == 150 and s[-1] == 300 and len(s) == 48


def test_reference_loader_rederives_the_ports_batches(tmp_path):
    """The plain loader over the raw files gives the port's loader's
    batches, bit for bit, subsampling draws included."""
    from pharmaforge_tpu_torch.data.datamodule import CrossdockedDataModule
    cell = tiny.cell("full-train")
    data = traffic.write_processed(tmp_path, np.random.default_rng(5),
                                   [16, 16, 4], [40, 70], [3, 12], [6, 40],
                                   11, 6)
    ds = dict(cell.config["dataset"], processed_data_dir=str(data),
              raw_data_dir="")
    dm = CrossdockedDataModule(ds, 4, validation_splits=[2])
    dm.setup("fit")
    ported = list(dm.train_dataloader(seed=11))
    plain = list(rl.batches(rl.Complexes(data, [0, 1]), 4, 11,
                            ds["subsample_min"], ds["subsample_max"], 6,
                            11))
    assert len(ported) == len(plain) >= 8
    for a, b in zip(ported, plain):
        for k, v in b.items():
            np.testing.assert_array_equal(getattr(a, k), v)
