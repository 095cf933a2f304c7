"""Run-directory checkpoints.

Port of `pharmaforge_tpu/training/checkpoints.py` with `torch.save` files
in place of orbax trees, keeping the JAX package's layout (reference
train.py:113-130):

    <run_dir>/checkpoints/
        last/          most recent state (the resume target)
        top/<step>/    the best `save_top_k` by the monitored metric
        top_index.json [(metric, step), ...] of the kept top-k

Each checkpoint directory holds one `<item>.pt` per state item -- the
model's weights (`model.pt`, the reference state-dict layout of
`interop.py`), the optimizer (`optimizer.pt`), the trainer's random
generator (`rng.pt`) -- and `meta.json` with step, epoch, lr, the plateau
scheduler's state and the monitored value.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

import torch


class RunCheckpointer:

    def __init__(self, run_dir: Path, save_last: bool = True,
                 save_top_k: int = 3, mode: str = "min", **_unused):
        """`checkpointing` config keys; the others (`monitor`,
        `every_n_epochs`) are accepted and, as in the JAX package, not
        read: the trainer saves each epoch on 'val total loss'."""
        self.ckpt_dir = Path(run_dir) / "checkpoints"
        self.save_last = save_last
        self.save_top_k = save_top_k
        self.mode = mode
        self._top: list = []  # (metric, step)
        index = self.ckpt_dir / "top_index.json"
        if index.exists():
            self._top = [tuple(x) for x in json.loads(index.read_text())]

    @staticmethod
    def _write(path: Path, state: dict, meta: dict) -> None:
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        for k, v in state.items():
            torch.save(v, path / f"{k}.pt")
        (path / "meta.json").write_text(json.dumps(meta))

    def save(self, state: dict, meta: dict,
             metric: Optional[float] = None) -> None:
        """Write `last` and update the top-k set. Only this method writes
        (under data parallelism the trainer calls it on rank 0 alone)."""
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        step = int(meta.get("step", 0))
        if self.save_last:
            self._write(self.ckpt_dir / "last", state, meta)
        if metric is not None and self.save_top_k > 0:
            self._top.append((float(metric), step))
            self._top.sort(key=lambda x: x[0], reverse=self.mode == "max")
            keep, drop = (self._top[:self.save_top_k],
                          self._top[self.save_top_k:])
            if any(s == step for _, s in keep):
                self._write(self.ckpt_dir / "top" / str(step), state, meta)
            for _, s in drop:
                shutil.rmtree(self.ckpt_dir / "top" / str(s),
                              ignore_errors=True)
            self._top = keep
            (self.ckpt_dir / "top_index.json").write_text(
                json.dumps(self._top))

    def path_of(self, which: str = "last") -> Path:
        """'last', 'best' or a checkpoint directory ('last.ckpt', the
        reference's name, means 'last')."""
        if which == "last":
            return self.ckpt_dir / "last"
        if which == "best":
            if not self._top:
                raise FileNotFoundError("no top-k checkpoints recorded")
            return self.ckpt_dir / "top" / str(self._top[0][1])
        path = Path(which)
        return path.parent / "last" if path.name == "last.ckpt" else path

    def restore(self, which: str = "last") -> tuple:
        """(state, meta) of a checkpoint, tensors on the CPU."""
        path = self.path_of(which)
        state = {f.stem: torch.load(f, map_location="cpu", weights_only=True)
                 for f in sorted(path.glob("*.pt"))}
        return state, json.loads((path / "meta.json").read_text())
