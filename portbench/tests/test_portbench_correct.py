"""The comparison that decides `correct`: a sound run of each cell passes
at the cell's limits; a run whose timed path is broken underneath fails,
once for each fault the cell can have; the control (the reference in the
precision below the configuration's, in the program's place) fails.

On the CPU the cells run at a tiny size (`tiny.py`), past the harness's
look for a card; the controls whose lower precision exists only on the
card (TF32) run there, at the cells' own sizes."""

from __future__ import annotations

import argparse
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from portbench import calibrate, harness, manifest
from portbench.tests import tiny

SEED = 2 ** 31 + 4099
SAMPLING = ["full-screen"]
TRAINING = ["full-train", "dev-train"]
# the one-pocket mix, which no cell runs yet (the chain runner captures
# again on every change of bucket): pforge-dev in fp32, held on the CPU
# at limits well above fp32 rounding and well below the faults' readings
POCKET = dict(config="pforge-dev", traffic="pocket-30",
              limits={"h_gap": {"limit": 1.5e-3},
                      "x_gap_median": {"limit": 1e-4}},
              end_to_end=[{"name": "pocket_p95_ms", "unit": "ms"},
                          {"name": "setup_s", "unit": "s"}])


def run_cell(cell) -> dict:
    """A whole run of `cell` on the CPU with one host thread, as
    `run.py` holds it: the result line."""
    torch.set_num_threads(1)
    args = argparse.Namespace(workload=cell.name, seed=SEED, seconds=2.0,
                              trace=0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run_cell(args, cell, torch.device("cpu"), 0.0)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def run_tiny(name: str) -> dict:
    """A whole run of the tiny cell `name` at its own limits (`pocket`:
    the one-pocket mix at `POCKET`'s): the result line."""
    if name == "pocket":
        return run_cell(tiny.unlisted(**POCKET))
    full = manifest.Cell.find(manifest.load_manifest(), name)
    cell = tiny.cell(name)
    cell.limits = full.limits
    return run_cell(cell)


def unchanged_step(monkeypatch):
    """Every reverse step returns the chain's state unchanged."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion

    def step(self, chain):
        chain.state["i"].add_(1)

    monkeypatch.setattr(PharmacophoreDiffusion, "chain_step", step)


def half_batch_chain(monkeypatch):
    """Every reverse step advances the first half of the batch only."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    real = PharmacophoreDiffusion.chain_step

    def step(self, chain):
        st = chain.state
        half = st["x"].shape[0] // 2
        kept = {k: st[k][half:].clone() for k in ("x", "h", "prot_x")}
        real(self, chain)
        for k, v in kept.items():
            st[k][half:] = v

    monkeypatch.setattr(PharmacophoreDiffusion, "chain_step", step)


def altered_answer(monkeypatch):
    """Every answer altered where it is made: its centres moved by 0.01 A
    and its type features by 0.01."""
    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    real = PharmacophoreDiffusion.chain_result

    def result(self, chain):
        out = real(self, chain)
        out["pharm_x"] = out["pharm_x"] + 0.01
        out["pharm_h"] = out["pharm_h"] + 0.01
        return out

    monkeypatch.setattr(PharmacophoreDiffusion, "chain_result", result)


def unchanged_state(monkeypatch):
    """The optimizer step leaves the weights and its state unchanged."""
    from pharmaforge_tpu_torch.training.optim import Adam
    monkeypatch.setattr(Adam, "step", lambda self, lr=None: False)


def stale_batches(monkeypatch):
    """Every step of a call trains on the call's first batch."""
    from pharmaforge_tpu_torch.training import train_state
    real = train_state.unstack_batch
    monkeypatch.setattr(train_state, "unstack_batch",
                        lambda batches, j: real(batches, 0))


def half_batch_loss(monkeypatch):
    """The loss leaves out half of each batch: the mean over the rest."""
    import dataclasses

    from pharmaforge_tpu_torch.models.diffusion import PharmacophoreDiffusion
    real = PharmacophoreDiffusion.loss

    def loss(self, batch, *args, **kw):
        half = batch.pharm_x.shape[0] // 2
        return real(self, dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name)[:half]
            for f in dataclasses.fields(batch)}), *args, **kw)

    monkeypatch.setattr(PharmacophoreDiffusion, "loss", loss)


@pytest.mark.parametrize("name", SAMPLING + TRAINING + ["pocket"])
def test_a_sound_run_is_correct(name):
    result = run_tiny(name)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


def test_the_pocket_mix_reports_its_tail():
    result = run_tiny("pocket")
    assert set(result["metrics"]) == {"pocket_p95_ms", "setup_s"}
    assert result["metrics"]["pocket_p95_ms"]["value"] > 0


@pytest.mark.parametrize("name", SAMPLING + ["pocket"])
@pytest.mark.parametrize("fault", [unchanged_step, half_batch_chain,
                                   altered_answer])
def test_a_broken_chain_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    assert not run_tiny(name)["correct"]


@pytest.mark.parametrize("name", TRAINING)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch_loss,
                                   stale_batches])
def test_a_broken_train_step_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    assert not run_tiny(name)["correct"]


def fails(readings, limits) -> bool:
    return any(readings[k] > v["limit"] for k, v in limits.items())


def test_the_fp8_control_fails_full_screen():
    """pforge-full samples with bf16 edge chains; its control rounds the
    reference's edge chains to fp8 and must fail a compared number."""
    full = manifest.Cell.find(manifest.load_manifest(), "full-screen")
    assert full.config["sampling"]["control"] == "float8"
    cell = tiny.cell("full-screen")
    got = dict(calibrate.readings(cell, SEED, 2, torch.device("cpu"),
                                  control=True, fault=False))
    assert not fails(got["program"], full.limits)
    assert fails(got["control"], full.limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAINING)
def test_the_tf32_control_fails_on_the_card(card, name):
    """The fp32 cells' control, TF32 matrix products in the reference put
    in the program's place, fails a compared number at the cell's size."""
    cell = manifest.Cell.find(manifest.load_manifest(), name)
    got = dict(calibrate.readings(cell, SEED, 0, card, control=True,
                                  fault=False))
    assert not fails(got["program"], cell.limits)
    assert fails(got["control"], cell.limits)
    assert np.isfinite(list(got["control"].values())).all()
